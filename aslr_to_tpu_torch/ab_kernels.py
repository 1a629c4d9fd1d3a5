"""Time the shared-path kernels of several checkouts of the repo side by
side on one card, for an A/B of a kernel source change.

    python -m aslr_to_tpu_torch.ab_kernels --trees build/parent . . build/parent

Each tree is a checkout (its root holds ``chip_smoke.py`` and
``aslr_to_tpu_torch``). Every tree first builds its kernels in its own
``build/`` directory, all trees at once; then each entry of ``--trees``, in
the order given, runs in a process of its own that imports that tree's
package and ``chip_smoke.py`` and times, with CUDA events over ``--reps``
launches after a warm-up, every case of its ``kernel_cases`` at the paths'
shapes in float32: K1 (VSA, SEA), K2, K4 (nu 2 and 4), K5, K3 and K6 (box,
unbounded, SEA gaps) at T=100, B=4096, and K1, K4, K3 and K6 at the 3- and
7-DoF arms' instances at T=100, B=1024. Each tree's build also reports its
``-Xptxas -v`` lines per instance (registers, stack frame, spills). The last
line is one JSON record: per tree, the ptxas lines; per run, the times.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

_CHILD = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from aslr_to_tpu_torch.kernels import build
mode = sys.argv[1]
build.lib()
if mode == "build":
    print(json.dumps(dict(ptxas=cs.kernel_ptxas(build.build_log, build.lib()))))
    raise SystemExit
reps = int(sys.argv[2])
torch.backends.cuda.matmul.allow_tf32 = False
times = {}
for label, case in cs.kernel_cases(torch.float32).items():
    times[label] = cs.cuda_ms(case[0], reps)
for label, case in cs.kernel_cases(torch.float32, 1024, ("sea3", "sea7"), T=100).items():
    times[f"{label} B=1024"] = cs.cuda_ms(case[0], reps)
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
    for tree in args.trees:
        times = _last_json(_run(tree, "time", str(args.reps)), tree)["times"]
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
