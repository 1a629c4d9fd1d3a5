"""``sharded_solve`` of the port (``aslr_to_tpu_torch/parallel/batch.py``):
the batch split over devices, a shard a device, each solved on its own
copy of the problem (``ShootingProblem.to``). On the CPU the devices are
the CPU named twice; each lane's result must be the unsharded solve's.
"""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest
import torch

from aslr_to_tpu_torch import SolverSettings, make_batched_solver, sharded_solve
from aslr_to_tpu_torch import two_dof_vsa_boxddp
from aslr_to_tpu_torch.solvers.problem import to_device

SETTINGS = SolverSettings(maxiter=4, th_stop=1e-6)


@pytest.fixture(scope="module")
def vsa():
    w = two_dof_vsa_boxddp(T=6, device="cpu")
    rng = np.random.default_rng(4)
    x0s = np.zeros((4, 8))
    x0s[:, :4] = 0.05 * rng.standard_normal((4, 4))
    return w, torch.tensor(x0s)


@pytest.mark.parametrize("route", [False, "lanes"], ids=["generic", "lanes"])
def test_sharded_solve_matches_the_unsharded_solve(vsa, route):
    """BoxDDP, B=4, T=6, f64, over two devices: equal iterations and flags on
    every lane, cost within rtol 1e-12, and the lanes in their order."""
    w, x0s = vsa
    whole = make_batched_solver(w.problem, SETTINGS, use_gaps=False, bounds=w.bounds,
                                use_fast_path=route)(x0s)
    shard = sharded_solve(w.problem, x0s, SETTINGS, use_gaps=False, bounds=w.bounds,
                          devices=["cpu", "cpu"], use_fast_path=route)
    for name in ("iterations", "converged", "diverged"):
        assert torch.equal(getattr(shard, name), getattr(whole, name)), name
    np.testing.assert_allclose(shard.cost.numpy(), whole.cost.numpy(), rtol=1e-12)
    assert shard.us.shape == whole.us.shape == (4, 6, 4)
    assert shard.cost.device == x0s.device


def test_sharded_solve_refusals(vsa):
    """A batch the devices do not divide, the ``gspmd`` partitioner, no CUDA
    device by default on a machine without one, and x0s off the problem's
    device each raise before any solve."""
    w, x0s = vsa
    kw = dict(use_gaps=False, bounds=w.bounds)
    with pytest.raises(ValueError, match="does not split into 3 equal shards"):
        sharded_solve(w.problem, x0s, SETTINGS, devices=["cpu"] * 3, **kw)
    with pytest.raises(ValueError, match="gspmd"):
        sharded_solve(w.problem, x0s, SETTINGS, devices=["cpu"], partitioner="gspmd", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharded_solve(w.problem, x0s, SETTINGS, **kw)
    with pytest.raises(ValueError, match="build the problem on the device of the solve"):
        sharded_solve(w.problem.to("meta"), x0s, SETTINGS, devices=["cpu"],
                      **dict(kw, bounds=to_device(w.bounds, "meta")))


def test_problem_moves_every_tensor(vsa):
    """``ShootingProblem.to`` moves every tensor leaf of the problem (the
    models' parameters and targets included) and keeps the rest."""
    w, _ = vsa
    moved = w.problem.to("meta")
    leaves = []

    def walk(obj):
        from aslr_to_tpu_torch.solvers.problem import _children
        if isinstance(obj, torch.Tensor):
            leaves.append(obj)
        for kid in _children(obj) or ():
            walk(kid)

    walk(moved)
    assert len(leaves) > 10 and all(t.device.type == "meta" for t in leaves)
    assert moved.T == w.problem.T and moved.per_knot == w.problem.per_knot


def test_sharded_solve_gives_each_device_its_contiguous_shard(vsa, monkeypatch):
    """Each device solves, in the devices' order, the next B / n scenarios
    on its own copy of the problem."""
    from aslr_to_tpu_torch.parallel import batch

    w, x0s = vsa
    seen = []
    build = batch.make_batched_solver

    def make(problem, *args, **kwargs):
        fn = build(problem, *args, **kwargs)

        def solve(x):
            seen.append((problem is not w.problem, x.clone()))
            return fn(x)

        return solve

    monkeypatch.setattr(batch, "make_batched_solver", make)
    sharded_solve(w.problem, x0s, SETTINGS, use_gaps=False, bounds=w.bounds,
                  devices=["cpu", "cpu"], use_fast_path="lanes")
    assert [copy for copy, _ in seen] == [True, True]
    assert torch.equal(seen[0][1], x0s[:2]) and torch.equal(seen[1][1], x0s[2:])


def test_each_cuda_device_launches_from_a_library_of_its_own(monkeypatch, tmp_path):
    """The launchers set a kernel's shared-memory limit once a library, on
    the device of its first launch, so the shards on other cards load a copy
    of the library each: the first device to ask keeps the library, every
    other one gets a file of its own from a ``-fno-gnu-unique`` build (no
    template static shared between the copies), loaded once."""
    from aslr_to_tpu_torch.kernels import build

    builds, loaded = [], []

    def fake_build(force=False, flags=None):
        builds.append(flags)
        out = tmp_path / ("unique.so" if flags else "main.so")
        out.write_bytes(b"lib")
        return out

    class FakeCDLL:
        def __init__(self, path):
            self.path = path
            loaded.append(path)

    device = [0]
    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build.ctypes, "CDLL", FakeCDLL)
    monkeypatch.setattr(build, "_bind", lambda handle: handle)
    monkeypatch.setattr(build, "_device", lambda: device[0])
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_home", None)
    monkeypatch.setattr(build, "_copies", {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: device[0])

    home = build.lib()
    assert build._home == 0 and home.path.endswith("main.so")
    device[0] = 1
    one = build.lib()
    assert one is not home and one.path.endswith(".cuda1.so")
    assert builds[-1][-2:] == ["-Xcompiler", "-fno-gnu-unique"]
    assert build.lib() is one
    device[0] = 2
    two = build.lib()
    assert two.path.endswith(".cuda2.so") and two is not one
    device[0] = 0
    assert build.lib() is home
    assert len(loaded) == 3
