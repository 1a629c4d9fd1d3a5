"""The port's scale-out layer (``aslr_to_tpu_torch/parallel/mesh.py``,
``spmd.py`` and ``launch.py``): a process a device, joined by
``torch.distributed``, each rank solving its shard at the same time.

Two ranks on the CPU (Gloo, f64, one torch thread each) run
``tests/torch_spmd_worker.py`` once, through the port's launcher, with
``ATEN_CPU_CAPABILITY=default``: on an AVX-512 host PyTorch's CPU kernels
run a row of 8 doubles through their scalar tail and a row of 16 through
SLEEF's vector functions, whose sine and cosine round otherwise in some
last bits, so the plain versions' bits would depend on the batch width,
shard against whole batch; the scalar kernels' do not. (a) the
generic FDDP on ``two_dof_sea(T=8)``, B=4, whose global statistics must
be identical on both ranks and equal the JAX package's ``shard_map_solve``
on a 2-device CPU mesh (the counterpart of ``tests/test_multihost.py`` and
``test_parallel.py::test_shard_map_solve_global_stats``; ``n_conv``
exactly, ``mean_cost`` within rtol 1e-6 of JAX's float32 sums), and whose
gathered result must match JAX's at ``tests/test_torch_solver.py``'s
tolerances; (b) the lane BoxDDP (``two_dof_vsa_boxddp(T=8)``, B=16,
maxiter 4, the plain versions, logs kept) over two ranks, equal to the
port's unsharded lane solve to the bit in every field (the counterpart of
``test_sharded_lane_solver_bit_parity``); (c) ``sharded_solve(mesh=...)``
equal to the series route. In this process: (d) the mesh outside a group
is one rank, and (e) a batch that the ranks do not divide raises; the
backend rule; the launcher's failures.
"""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aslr_to_tpu.parallel.mesh import make_batch_mesh as jax_make_batch_mesh
from aslr_to_tpu.parallel.spmd import shard_map_solve as jax_shard_map_solve
from aslr_to_tpu.solvers.ddp import SolverSettings as JaxSettings
from aslr_to_tpu.workloads.presets import two_dof_sea as jax_sea
from aslr_to_tpu_torch import make_batched_solver, sharded_solve
from aslr_to_tpu_torch.parallel import launch, mesh as mesh_mod
from aslr_to_tpu_torch.parallel.mesh import BatchMesh, distributed_init, make_batch_mesh
from aslr_to_tpu_torch.parallel.spmd import shard_map_solve, stats_of
from aslr_to_tpu_torch.solvers.ddp import SolveLog, SolveResult
from torch_lane_support import check_against_jax
from torch_spmd_worker import lane_case, sea_case

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_spmd_worker.py")


def _result(d):
    return SolveResult(*(d[f] for f in SolveResult._fields[:-1]),
                       SolveLog(*(d[f"log.{f}"] for f in SolveLog._fields)))


def _bits(t):
    if t.is_floating_point():
        return t.view({8: torch.int64, 4: torch.int32}[t.element_size()])
    return t


def _same_bits(got, want):
    """Every field and log series equal to the bit (NaN where NaN)."""
    for name, a, b in zip(SolveResult._fields[:-1] + SolveLog._fields,
                          [*got[:-1], *got.log], [*want[:-1], *want.log]):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(_bits(a), _bits(b)), name


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' saved results (one launch of the worker for the file)."""
    out = tmp_path_factory.mktemp("spmd")
    env = dict(os.environ, ATEN_CPU_CAPABILITY="default")
    texts = launch.run(2, [WORKER, str(out)], timeout=240, env=env)
    assert [f"rank {r} of 2 done" in t for r, t in enumerate(texts)] == [True, True], texts
    return [torch.load(out / f"rank{r}.pt") for r in range(2)]


def test_two_ranks_share_jax_shard_map_solves_global_stats(ranks):
    """(a) Gloo group of two ranks; statistics identical on both and equal to
    JAX's psum-reduced ones; the gathered result at the solver tolerances."""
    assert [(r["rank"], r["size"], r["backend"], r["device"], r["collective"])
            for r in ranks] == [(0, 2, "gloo", "cpu", "cpu"), (1, 2, "gloo", "cpu", "cpu")]
    assert torch.equal(ranks[0]["sea.stats"], ranks[1]["sea.stats"])
    _, x0s, settings, _ = sea_case()
    ref, (n_conv, mean_cost) = jax_shard_map_solve(
        jax_sea(T=8).problem, jnp.asarray(x0s.numpy()),
        JaxSettings(maxiter=settings.maxiter, th_stop=settings.th_stop), use_gaps=True,
        mesh=jax_make_batch_mesh(2))
    got_conv, got_cost = ranks[0]["sea.stats"].tolist()
    assert got_conv == float(n_conv)
    np.testing.assert_allclose(got_cost, float(mean_cost), rtol=1e-6)
    for r in ranks:
        check_against_jax(_result(r["sea"]), ref)


def test_lane_boxddp_over_two_ranks_is_the_unsharded_lane_solve(ranks):
    """(b) Every field and log series of the gathered lane solve equals the
    unsharded one's (rank 0's, outside the group) to the bit on both ranks,
    and the statistics equal those computed from it in the same way."""
    whole = _result(ranks[0]["lanes.whole"])
    for r in ranks:
        _same_bits(_result(r["lanes"]), whole)
        assert torch.equal(r["lanes.stats"], torch.stack(stats_of(whole, 2)))


def test_sharded_solve_with_a_mesh_is_the_series_route(ranks):
    """(c) ``sharded_solve(mesh=...)`` in the group against the shards in
    series in one process; and a batch the group does not divide raised in
    both ranks."""
    series = _result(ranks[0]["sharded.series"])
    for r in ranks:
        _same_bits(_result(r["sharded"]), series)
        assert r["odd batch"] == "a batch of 3 scenarios does not split into 2 equal shards"


def test_mesh_outside_a_group_is_one_rank(monkeypatch):
    """(d) Outside a group the mesh is this process alone, solving on the
    problem's device; ``distributed_init`` is a no-op for one process; a
    mesh of two devices needs two processes."""
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    one = BatchMesh(0, 1, None, None, None)
    assert make_batch_mesh() == make_batch_mesh(1) == distributed_init() == one
    assert distributed_init(num_processes=1) == one
    with pytest.raises(ValueError, match="start a process a device"):
        make_batch_mesh(2)
    problem, x0s, settings, kw = lane_case()
    res, (n_conv, mean_cost) = shard_map_solve(problem, x0s, settings, **kw)
    _same_bits(res, make_batched_solver(problem, settings, **kw)(x0s))
    want_conv, want_cost = stats_of(res, 1)
    assert torch.equal(n_conv, want_conv) and torch.equal(mean_cost, want_cost)
    assert n_conv.dtype == mean_cost.dtype == torch.float32


def test_a_batch_the_ranks_do_not_divide_raises():
    """(e) Before any solve or collective, as JAX requires B % n == 0."""
    problem, x0s, settings, kw = lane_case()
    two = BatchMesh(1, 2, torch.device("cpu"), "gloo", torch.device("cpu"))
    assert two.rows(16) == slice(8, 16)
    with pytest.raises(ValueError, match="a batch of 15 scenarios does not split into 2"):
        shard_map_solve(problem, x0s[:15], settings, mesh=two, **kw)
    with pytest.raises(ValueError, match="devices .* or mesh"):
        sharded_solve(problem, x0s, settings, devices=["cpu"], mesh=two)


@pytest.mark.parametrize("cards, local, device, backend, want", [
    (1, 2, None, None, ("gloo", "cuda:0", 0)),     # two ranks share the card: Gloo
    (4, 4, None, None, ("nccl", "cuda:3", 3)),     # a card each: NCCL
    (0, 2, "cpu", None, ("gloo", "cpu", None)),     # the CPU: Gloo
    (4, 4, None, "gloo", ("gloo", "cuda:3", 3)),   # named by the caller
], ids=["shared card", "card each", "cpu", "named"])
def test_distributed_init_backend_rule(monkeypatch, cards, local, device, backend, want):
    """The rank's device (``cuda:LOCAL_RANK`` modulo the cards, set current
    before any launch) and the backend rule, with the group's start
    recorded instead of made."""
    started, current = [], []
    monkeypatch.setattr(mesh_mod.dist, "init_process_group",
                        lambda backend, **kw: started.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: current.append(d))
    monkeypatch.setattr(mesh_mod, "_rank_device", {})
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local))
    distributed_init("localhost:1234", num_processes=local, process_id=3, device=device,
                     backend=backend)
    assert started == [(want[0], dict(init_method="tcp://localhost:1234", world_size=local,
                                      rank=3))]
    assert str(mesh_mod._rank_device["device"]) == want[1]
    assert [d.index for d in current] == ([] if want[2] is None else [want[2]])


def test_distributed_init_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device: pass device='cpu'"):
        distributed_init("localhost:1", num_processes=2, process_id=0)


def test_launch_environment_and_failures(capsys):
    """Each rank gets torchrun's environment on one free port; a rank that
    exits non-zero fails the launch and the others are killed; a launch
    that overruns its timeout fails; the command line exits 1 then."""
    code = ("import os; print('ENV', *(os.environ[k] for k in ('RANK', 'LOCAL_RANK', "
            "'WORLD_SIZE', 'LOCAL_WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT', "
            "'OMP_NUM_THREADS')))")
    outs = launch.run(3, ["-c", code], timeout=60)
    env = [o.split() for o in outs]
    assert [e[1:6] for e in env] == [[str(r), str(r), "3", "3", "localhost"] for r in range(3)]
    assert len({e[6] for e in env}) == 1 and {e[7] for e in env} == {"1"}
    fail = "import os, sys, time; sys.exit(3) if os.environ['RANK'] == '1' else time.sleep(60)"
    with launch.Ranks(2, ["-c", fail], timeout=60) as ranks:
        with pytest.raises(launch.LaunchError, match=r"rank\(s\) \[1\] exited non-zero"):
            ranks.wait()
        assert [p.returncode for p in ranks.procs][1] == 3
        assert ranks.procs[0].returncode is not None      # killed, not left running
    with pytest.raises(launch.LaunchError, match="overran its timeout of 1"):
        launch.run(2, ["-c", "import time; time.sleep(60)"], timeout=1)
    assert launch.main(["--nproc-per-node", "2", "--timeout=30", "-c", fail]) == 1
    assert "launch failed" in capsys.readouterr().err
    assert launch.main(["--nproc", "1", "-c", "print('hello')"]) == 0
    assert "[rank 0] hello" in capsys.readouterr().out
