"""A rank of ``tests/test_torch_spmd.py``: two copies are started by
``aslr_to_tpu_torch.parallel.launch`` (``python tests/torch_spmd_worker.py
OUT``). Each joins the Gloo group on the CPU through ``distributed_init``,
runs the cases through ``shard_map_solve`` (and the lane case through
``sharded_solve`` with the mesh) and a batch that the ranks do not divide,
and saves what it got to ``OUT/rank<r>.pt``: the gathered results, its
global statistics and its mesh. Rank 0 also saves the references that
the test holds them to, computed in the same process outside the group:
the unsharded lane solve and the series route of ``sharded_solve``.
"""
import os
import sys

import numpy as np
import torch

# one torch thread a rank, as tests/torch_cpu.py sets for a test process
torch.set_num_threads(1)
T = 8


def sea_case():
    """(a): the generic FDDP on two_dof_sea, B=4, as test_torch_solver.py's
    "fddp" case."""
    from aslr_to_tpu_torch import SolverSettings, two_dof_sea

    w = two_dof_sea(T=T, device="cpu")
    x0s = torch.tensor(0.3 * np.random.default_rng(2).standard_normal((4, 8)))
    return w.problem, x0s, SolverSettings(maxiter=8, th_stop=1e-9), dict(use_gaps=True)


def lane_case():
    """(b): the lane BoxDDP on two_dof_vsa_boxddp, B=16, maxiter 4, as
    tests/test_parallel.py's lane bit-parity case, with the logs kept."""
    from aslr_to_tpu_torch import SolverSettings, two_dof_vsa_boxddp

    w = two_dof_vsa_boxddp(T=T, device="cpu")
    x0s = torch.tensor(0.05 * np.random.default_rng(1).standard_normal((16, 8)))
    return w.problem, x0s, SolverSettings(maxiter=4, th_stop=1e-7), dict(
        use_gaps=False, bounds=w.bounds, use_fast_path="lanes", keep_log=True)


def as_dict(res):
    """A SolveResult as a dict of tensors (``torch.load`` reads it back
    with ``weights_only``)."""
    out = {k: v for k, v in res._asdict().items() if k != "log"}
    out.update({f"log.{k}": v for k, v in res.log._asdict().items()})
    return out


def main(out_dir):
    import torch.distributed as dist

    from aslr_to_tpu_torch import make_batched_solver, sharded_solve
    from aslr_to_tpu_torch.parallel.mesh import distributed_init, make_batch_mesh
    from aslr_to_tpu_torch.parallel.spmd import shard_map_solve

    mesh = distributed_init(device="cpu")
    try:
        if make_batch_mesh() != mesh:
            raise AssertionError(f"make_batch_mesh() {make_batch_mesh()} is not {mesh}")
        saved = dict(rank=mesh.rank, size=mesh.size, backend=mesh.backend,
                     device=str(mesh.device), collective=str(mesh.collective_device))
        for name, case in (("sea", sea_case), ("lanes", lane_case)):
            problem, x0s, settings, kw = case()
            res, (n_conv, mean_cost) = shard_map_solve(problem, x0s, settings, mesh=mesh, **kw)
            saved[name] = as_dict(res)
            saved[f"{name}.stats"] = torch.stack([n_conv, mean_cost])
        problem, x0s, settings, kw = lane_case()
        kw.pop("keep_log")
        saved["sharded"] = as_dict(sharded_solve(problem, x0s, settings, mesh=mesh, **kw))
        try:
            shard_map_solve(problem, x0s[:3], settings, mesh=mesh, **kw)
        except ValueError as e:
            saved["odd batch"] = str(e)
        if mesh.rank == 0:
            problem, x0s, settings, kw = lane_case()
            saved["lanes.whole"] = as_dict(make_batched_solver(problem, settings, **kw)(x0s))
            kw.pop("keep_log")
            saved["sharded.series"] = as_dict(sharded_solve(problem, x0s, settings,
                                                            devices=["cpu", "cpu"], **kw))
        torch.save(saved, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    finally:
        dist.destroy_process_group()
    print(f"rank {mesh.rank} of {mesh.size} done", flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
