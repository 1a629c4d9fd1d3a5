"""Batched sweep: thousands of VSA BoxDDP scenarios at once, the port of
``examples/batched_sweep.py``: one batch of perturbed initial states (the
link and motor positions; velocity noise on the stiff spring-coupled arm
starts violent transients) solved a shard a card, timed after a first
solve, with its ``convergence_summary``. T=100, B=2048, maxiter 20,
th_stop 1e-5, f32, on the lane route.

Two routes. By default ``sharded_solve`` in this process over every
visible card (``--devices cpu,cpu`` names others), the shards one after
another, so the rate does not grow with the cards. With ``--spmd`` a rank
a card, each solving its shard at the same time through
``shard_map_solve``, which prints the global statistics and the rate over
the cards; start the ranks with

    python -m aslr_to_tpu_torch.parallel.launch --nproc-per-node 4 \\
        -m aslr_to_tpu_torch.examples.batched_sweep --spmd --batch 16384

or ``torchrun --nproc-per-node=4 -m aslr_to_tpu_torch.examples.batched_sweep
--spmd`` (``--devices cpu``: the ranks on the CPU, over Gloo). Run alone,
``--spmd`` is one rank solving the whole batch.
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
         dtype: str = "float32", spmd: bool = False):
    """``devices``: the shards' devices, comma-separated (default: every
    visible CUDA device); with ``spmd`` "" (each rank its card) or "cpu"."""
    from aslr_to_tpu_torch.parallel.batch import convergence_summary, sharded_solve
    from aslr_to_tpu_torch.solvers.ddp import SolverSettings
    from aslr_to_tpu_torch.workloads.presets import two_dof_vsa_boxddp

    dt = getattr(torch, dtype)
    settings = SolverSettings(maxiter=maxiter, th_stop=1e-5)
    if spmd:
        return _spmd(batch, T, settings, devices, dt)
    devs = ([torch.device(d) for d in devices.split(",")] if devices else
            [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    if not devs:
        raise RuntimeError("batched_sweep found no CUDA device: pass --devices to name "
                           "the devices of the shards")
    w = two_dof_vsa_boxddp(T=T, dtype=dt, device=devs[0])
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


def _spmd(batch, T, settings, devices, dt):
    """The sweep as a rank of a group (or alone): the timed solve from a
    barrier before it to one after the gathered result."""
    import torch.distributed as dist

    from aslr_to_tpu_torch.parallel.batch import convergence_summary
    from aslr_to_tpu_torch.parallel.mesh import distributed_init
    from aslr_to_tpu_torch.parallel.spmd import shard_map_solve
    from aslr_to_tpu_torch.workloads.presets import two_dof_vsa_boxddp

    if devices not in ("", "cpu"):
        raise ValueError(f"--spmd runs each rank on its card (--devices '') or every rank on "
                         f"the CPU (--devices cpu), got {devices!r}")
    mesh = distributed_init(device=devices or None)
    try:
        dev = mesh.device or torch.device(devices or "cuda")
        w = two_dof_vsa_boxddp(T=T, dtype=dt, device=dev)
        x0s = sweep_x0s(batch, w.problem.state.nx, dt, dev)

        def run(x):
            return shard_map_solve(w.problem, x, settings, use_gaps=False, bounds=w.bounds,
                                   use_fast_path="lanes", mesh=mesh)

        t0 = time.perf_counter()
        run(x0s)
        _sync([dev])
        print(f"first solve: {time.perf_counter() - t0:.1f}s")
        mesh.barrier()
        t0 = time.perf_counter()
        res, (n_conv, mean_cost) = run(x0s + 1e-4)
        _sync([dev])
        mesh.barrier()
        dt_s = time.perf_counter() - t0
        print(f"{batch} solves in {dt_s:.4f}s -> {batch / dt_s:.2f} solves/s over {mesh.size} "
              f"rank(s), a shard each at the same time (rank {mesh.rank} on {dev}, backend "
              f"{mesh.backend})")
        print(f"global statistics: n_converged {float(n_conv)!r}, mean_cost "
              f"{float(mean_cost)!r}")
        summary = convergence_summary(res)
        print(summary)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return res, summary


if __name__ == "__main__":
    cli(main)
