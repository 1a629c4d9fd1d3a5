"""Batched sweep: thousands of VSA BoxDDP scenarios at once, the port of
``examples/batched_sweep.py``: one batch of perturbed initial states (the
link and motor positions; velocity noise on the stiff spring-coupled arm
starts violent transients) solved by ``sharded_solve`` over every visible
card (``--devices cpu,cpu`` names others), a shard a card, the shards one
after another (so the rate does not grow with the cards), timed after a
first solve, and its ``convergence_summary``. T=100, B=2048, maxiter 20,
th_stop 1e-5, f32, on the lane route.
"""
import time

import torch

from aslr_to_tpu_torch.examples import cli


def _sync(devices):
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def sweep_x0s(batch, nx, dtype, device):
    """The sweep's initial states: seeded noise of 0.02 on the positions,
    zero velocities."""
    g = torch.Generator().manual_seed(0)
    noise = 0.02 * torch.randn(batch, nx, generator=g, dtype=torch.float64)
    noise[:, nx // 2:] = 0.0
    return noise.to(dtype=dtype, device=device)


def main(batch: int = 2048, T: int = 100, maxiter: int = 20, devices: str = "",
         dtype: str = "float32"):
    """``devices``: the shards' devices, comma-separated (default: every
    visible CUDA device)."""
    from aslr_to_tpu_torch.parallel.batch import convergence_summary, sharded_solve
    from aslr_to_tpu_torch.solvers.ddp import SolverSettings
    from aslr_to_tpu_torch.workloads.presets import two_dof_vsa_boxddp

    dt = getattr(torch, dtype)
    devs = ([torch.device(d) for d in devices.split(",")] if devices else
            [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    if not devs:
        raise RuntimeError("batched_sweep found no CUDA device: pass --devices to name "
                           "the devices of the shards")
    w = two_dof_vsa_boxddp(T=T, dtype=dt, device=devs[0])
    settings = SolverSettings(maxiter=maxiter, th_stop=1e-5)
    x0s = sweep_x0s(batch, w.problem.state.nx, dt, devs[0])

    def run(x):
        return sharded_solve(w.problem, x, settings, use_gaps=False, bounds=w.bounds,
                             devices=devs, use_fast_path="lanes")

    t0 = time.perf_counter()
    res = run(x0s)
    _sync(devs)
    print(f"first solve: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    res = run(x0s + 1e-4)
    _sync(devs)
    dt_s = time.perf_counter() - t0
    print(f"{batch} solves in {dt_s:.2f}s -> {batch / dt_s:.0f} solves/s on {len(devs)} "
          f"device(s), a shard each, one after another")
    summary = convergence_summary(res)
    print(summary)
    return res, summary


if __name__ == "__main__":
    cli(main)
