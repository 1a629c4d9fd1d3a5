"""Time the shared-path kernels of several checkouts of the repo side by
side on one card, for an A/B of a kernel source change.

    python -m aslr_to_tpu_torch.ab_kernels --trees build/parent . . build/parent
    python -m aslr_to_tpu_torch.ab_kernels --trees build/parent . . build/parent --iterate
    python -m aslr_to_tpu_torch.ab_kernels --trees build/parent . --cases 'gaps. B=4096'

Each tree is a checkout (its root holds ``chip_smoke.py`` and
``aslr_to_tpu_torch``). Every tree first builds its kernels in its own
``build/`` directory, all trees at once; then each entry of ``--trees``, in
the order given, runs in a process of its own that imports that tree's
package and ``chip_smoke.py`` and times, with CUDA events over ``--reps``
launches after a warm-up, every case of its ``kernel_cases`` at the paths'
shapes in float32: K1 (VSA, SEA), K2, K4 (nu 2 and 4), K5, K3 and K6 (box,
unbounded, SEA gaps) at T=100, B=4096, K1, K4, K3 and K6 at the 3- and
7-DoF arms' instances at T=100, B=1024, and the 7-DoF ones again at
B=4096; then K5 at (28, 7) on the inputs of chip_smoke's n-DoF box kernel
phase (``ndof_box_cases``: the sevendof_box path's box, warm from zero
kprev) at B=1024 and 4096. Each tree's build also reports its
``-Xptxas -v`` lines per instance (registers, stack frame, spills).

``--iterate`` adds the inputs that K1 and K3 at nl 7 receive inside the
7-DoF lane solve (measure.py's ``sevendof`` path, seed 3) at B=1024 and
4096, and K5 at (28, 7) inside the 7-DoF box lane solve (``sevendof_box``,
seed 8) at B=1024: the first tree, in a process of its own, runs the
solves and keeps the arguments of the linearization of loop pass
``--iterate-pass`` and of the first two-trial rollout after it, and of
K5's last launch in chip_smoke's ``k5_iterate`` (3 passes)
(``build/ab_iterate.pt`` under the working directory); every run then
times each tree's kernels on them too, after holding each to its plain
version to the bit there ("K1 sea7 iterate", "K3 sea7 iterate", "K5 sea7
box iterate"). ``--cases`` times only the cases whose label
matches a regular expression, so that no other kernel runs before them in
a tree's process. The last line is one JSON record: per tree, the ptxas
lines; per run, the times. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

_CHILD = r"""
import json, re, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from aslr_to_tpu_torch.kernels import build
mode = sys.argv[1]
if mode == "build":  # compiled anew, so that the log holds every ptxas line
    build.build(force=True)
    print(json.dumps(dict(ptxas=cs.kernel_ptxas(build.build_log, build.lib()))))
    raise SystemExit
build.lib()
from aslr_to_tpu_torch import measure, seven_dof_sea
from aslr_to_tpu_torch.kernels import lane_solver
from aslr_to_tpu_torch.kernels import vsa_kernels as vk
if mode == "capture":  # the solver's inputs of K1 and K3 at nl 7 at one loop pass
    fname, at = sys.argv[2], int(sys.argv[3])
    captured = {}
    for B in (1024, 4096):
        seen, got = dict(passes=0), {}

        def keep(fn, name):
            def call(spec, *args):
                if name == "linearize":
                    seen["passes"] += 1
                if seen["passes"] == at and name not in got:
                    got[name] = [a.clone() if torch.is_tensor(a) else a for a in args]
                return fn(spec, *args)
            return call

        own = lane_solver.linearize, lane_solver.rollout2
        lane_solver.linearize = keep(own[0], "linearize")
        lane_solver.rollout2 = keep(own[1], "rollout2")
        try:
            path = measure.build_path("sevendof", B)
            path.solve(*path.args(0, path.setup()))
        finally:
            lane_solver.linearize, lane_solver.rollout2 = own
        if len(got) != 2:
            raise SystemExit(f"B={B}: the solve ran {seen['passes']} passes, not {at}")
        if B == 1024:  # K5 at (28, 7) in the sevendof_box solve
            got["riccati_boxfddp"] = [a.clone() if torch.is_tensor(a) else a
                                      for a in cs.k5_iterate(torch.float32, B)]
        captured[B] = got
    torch.save(captured, fname)
    print(json.dumps(dict(captured=sorted(captured))))
    raise SystemExit
reps, cases = int(sys.argv[2]), re.compile(sys.argv[3])
torch.backends.cuda.matmul.allow_tf32 = False
times = {}
for label, case in cs.kernel_cases(torch.float32).items():
    if cases.search(label):
        times[label] = cs.cuda_ms(case[0], reps)
for label, case in cs.kernel_cases(torch.float32, 1024, ("sea3", "sea7"), T=100).items():
    if cases.search(f"{label} B=1024"):
        times[f"{label} B=1024"] = cs.cuda_ms(case[0], reps)
for label, case in cs.kernel_cases(torch.float32, 4096, ("sea7",), T=100).items():
    if cases.search(f"{label} B=4096"):
        times[f"{label} B=4096"] = cs.cuda_ms(case[0], reps)
for B in (1024, 4096):  # K5 at (28, 7) on the n-DoF box kernel phase's inputs
    label = f"riccati_boxfddp[sea7 box] B={B}"
    if cases.search(label):
        times[label] = cs.cuda_ms(cs.ndof_box_cases(torch.float32, B, ("sea7",))
                                  ["riccati_boxfddp[sea7 box]"][0], reps)
        torch.cuda.empty_cache()
if len(sys.argv) > 4:  # the captured solver iterate, held to the plain versions first
    w = seven_dof_sea(T=100, dtype=torch.float32)
    spec = vk.extract_vsa_spec(w.problem, None)
    from aslr_to_tpu_torch.kernels import riccati as rk
    for B, got in torch.load(sys.argv[4]).items():
        for label, fn, plain, args in (
                ("K1 sea7 iterate", vk.linearize, vk.linearize_plain, [spec] + got["linearize"]),
                ("K3 sea7 iterate", vk.rollout2, vk.rollout2_plain, [spec] + got["rollout2"]),
                ("K5 sea7 box iterate", rk.riccati_boxfddp_backward, rk.riccati_boxfddp_plain,
                 got.get("riccati_boxfddp"))):
            if args is None or not cases.search(f"{label} B={B}"):
                continue
            want, out = cs.flat(plain(*args)), cs.flat(fn(*args))
            differ = [k for k, v in out.items() if not cs.same_bits(v, want[k])]
            if differ:
                raise SystemExit(f"{label} B={B}: {differ} differ from the plain version")
            times[f"{label} B={B}"] = cs.cuda_ms(lambda: fn(*args), reps)
print(json.dumps(dict(times=times)))
"""


def _run(tree, *args):
    env = dict(os.environ, PYTHONPATH=str(Path(tree).resolve()))
    return subprocess.Popen([sys.executable, "-c", _CHILD, *args], cwd=tree, env=env,
                            stdout=subprocess.PIPE, text=True)


def _last_json(proc, tree):
    out, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n{out}")
    return json.loads(out.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--iterate", action="store_true",
                    help="also time K1 and K3 at nl 7 on a 7-DoF lane solve's inputs, and K5 "
                         "at (28, 7) on a 7-DoF box lane solve's")
    ap.add_argument("--iterate-pass", type=int, default=5,
                    help="the loop pass whose inputs --iterate keeps")
    ap.add_argument("--cases", default="",
                    help="time only the cases whose label matches this regular expression, "
                         "so that no other kernel runs before them in the process")
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    trees = list(dict.fromkeys(args.trees))
    builds = {t: _run(t, "build") for t in trees}
    record = dict(card=card, ptxas={}, runs=[])
    for tree, proc in builds.items():
        record["ptxas"][tree] = _last_json(proc, tree)["ptxas"]
        print(f"== {tree}", flush=True)
        for line in record["ptxas"][tree]:
            print(f"  {line}", flush=True)
    extra = []
    if args.iterate:
        fname = str(Path("build/ab_iterate.pt").resolve())
        Path(fname).parent.mkdir(parents=True, exist_ok=True)
        _last_json(_run(args.trees[0], "capture", fname, str(args.iterate_pass)), args.trees[0])
        extra = [fname]
    for tree in args.trees:
        times = _last_json(_run(tree, "time", str(args.reps), args.cases, *extra),
                           tree)["times"]
        record["runs"].append(dict(tree=tree, times=times))
        print(f"== {tree}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()), flush=True)
    # each case's mean time per tree, against the first tree's
    base = args.trees[0]
    means = {t: {} for t in trees}
    for t in trees:
        runs = [r["times"] for r in record["runs"] if r["tree"] == t]
        for label in runs[0]:
            means[t][label] = sum(r[label] for r in runs) / len(runs)
    for label in means[base]:
        row = ", ".join(f"{t} {means[t][label]:.4f} ms ({means[t][label] / means[base][label]:.4f})"
                        for t in trees if label in means[t])
        print(f"  {label}: {row}", flush=True)
    record["means"] = means
    print(json.dumps(record))


if __name__ == "__main__":
    main()
