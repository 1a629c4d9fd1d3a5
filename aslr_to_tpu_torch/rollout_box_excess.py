"""Time the 7-DoF rollouts' box variants against their unboxed twins on the
same inputs, to tell whether the box's excess is the code's or the data's.

    python -m aslr_to_tpu_torch.rollout_box_excess [--batch 1024] [--passes 3]

K3 (two trials) and K6 (one) at nl 7 in BoxFDDP's variant ("sea box gaps")
against FDDP's ("sea gaps": the same gaps, no box), on three inputs:

  kernel   chip_smoke's n-DoF box kernel phase (``ndof_box_cases``: the
           quasi-static controls, K5's gains, the sevendof_box path's box,
           which binds), as timed in PERF.md;
  wide     the same with a box of ±1e6, which no control reaches: the
           variants then compute the same trajectories, so what is left of
           the excess is the box variant's code;
  iterate  the arguments of the first two-trial rollout after loop pass
           ``--passes`` of the sevendof_box lane solve (measure.py, seed 8),
           most of whose lanes diverge;
and, as chip_smoke's rows compare them, the box variant of ``kernel``
against DDP's ("sea": no box, no gaps) on K4's gains (case ``rows``).

Each case: both variants timed with CUDA events over 10 launches after a
warm-up, in turn (box, twin, twin, box); the box variant's excess; the
share of its first trial's controls on a bound; and, of the link angles
(state rows 0-6) that each variant's first trial reaches, the shares that
are not finite and that are finite beyond 105,615 rad, where ``sinf`` and
``cosf`` leave their fast range reduction for the slow one. Prints a line
per case and, last, one JSON record. Must run from the repository's root
(it imports ``chip_smoke``); needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

SINF_FAST = 105615.0    # |x| above which CUDA's sinf/cosf reduce the slow way


def _angles(trial, nl):
    """Shares of the link angles (rows 0 .. nl - 1 of the trial's states)
    that are not finite, and finite beyond SINF_FAST."""
    q = trial.xs[:, :nl].double()
    finite = torch.isfinite(q)
    return (float((~finite).double().mean()),
            float((finite & (q.abs() > SINF_FAST)).double().mean()))


def capture(B, passes, path="sevendof_box"):
    """The arguments of the first K3 launch after loop pass ``passes`` of a
    7-DoF lane solve (measure.py's ``path``: sevendof_box, sevendof or
    sevendof_ddp; through the kernels)."""
    from .kernels import lane_solver
    from .measure import SEEDS, sevendof_solver, x0_batch

    seen, got = dict(passes=0), []
    own = lane_solver.linearize, lane_solver.rollout2

    def lin(*args, **kw):
        seen["passes"] += 1
        return own[0](*args, **kw)

    def roll(*args, **kw):
        if seen["passes"] == passes and not got:
            got.append([a.clone() if torch.is_tensor(a) else a for a in args])
        return own[1](*args, **kw)

    lane_solver.linearize, lane_solver.rollout2 = lin, roll
    try:
        solve = sevendof_solver(path, dtype=torch.float32, maxiter=passes + 1)
        solve(x0_batch(B, torch.float32, SEEDS[path], nx=28))
    finally:
        lane_solver.linearize, lane_solver.rollout2 = own
    torch.cuda.synchronize()
    if not got:
        raise SystemExit(f"the solve ran {seen['passes']} passes, not {passes}")
    return got[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--passes", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the rollouts are timed on the card")
    sys.path.insert(0, ".")
    import chip_smoke as cs
    from .kernels import vsa_kernels as vk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    B, nl = args.batch, 7
    cases = cs.ndof_box_cases(torch.float32, B, ("sea7",))
    kernel = list(cases["rollout2[sea7 box gaps]"][0].args)   # spec .. wterm, lb, ub, fs, infeas
    wide = list(kernel)
    wide[9], wide[10] = (torch.full_like(kernel[9], v) for v in (-1e6, 1e6))
    iterate = capture(B, args.passes)
    # each case: the box variant's arguments, the other's and its name
    inputs = {name: (box, box[:9] + [None, None] + box[11:], "gaps")
              for name, box in (("kernel", kernel), ("wide", wide), ("iterate", iterate))}
    inputs["rows"] = (kernel, list(cases["rollout2[sea7]"][0].args), "sea")
    record = dict(card=card, batch=B, cases={})
    for case, (box, twin, other) in inputs.items():
        rec = record["cases"][case] = {}
        for kernel_name, fn, pick in (("K3", vk.rollout2, lambda a: a),
                                      ("K6", vk.rollout1, lambda a: a[:6] + a[7:])):
            calls = {"box gaps": lambda f=fn, a=pick(box): f(*a),
                     other: lambda f=fn, a=pick(twin): f(*a)}
            ms = {v: [] for v in calls}
            for v in ("box gaps", other, other, "box gaps"):
                ms[v].append(cs.cuda_ms(calls[v], 10))
            out = {v: calls[v]() for v in calls}
            first = {v: (o[0] if kernel_name == "K3" else o) for v, o in out.items()}
            lb, ub = box[9][None], box[10][None]
            on = float(((first["box gaps"].us == lb) | (first["box gaps"].us == ub))
                       .double().mean())
            row = dict(ms={v: sum(t) / len(t) for v, t in ms.items()}, on_bound=on,
                       angles={v: _angles(first[v], nl) for v in first})
            row["excess"] = row["ms"]["box gaps"] / row["ms"][other] - 1.0
            rec[kernel_name] = row
            print(f"{case} {kernel_name} B={B}: box gaps {row['ms']['box gaps']:.4f} ms, {other} "
                  f"{row['ms'][other]:.4f} ms, excess {100 * row['excess']:.2f}%; first trial's "
                  f"controls on a bound {100 * on:.2f}%; link angles not finite / beyond "
                  f"{SINF_FAST:.0f}: box " + "{:.4%} / {:.4%}".format(*row["angles"]["box gaps"])
                  + f", {other} " + "{:.4%} / {:.4%}".format(*row["angles"][other]), flush=True)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
