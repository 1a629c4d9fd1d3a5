"""The port's batched BoxDDP main path, end to end, against the JAX package.

Each case solves the same initial states (seeded numpy, float64) with the
port's lane solver (plain versions on the CPU) and with the JAX package's
``make_batched_solver(..., use_fast_path=False)``, i.e. ``jit(vmap(solve))``,
and holds them to the tolerances of ``tests/test_lane_solver.py::_check``:
cost rtol 1e-8, xs and us atol 1e-8, stop rtol 1e-6, reg rtol 1e-8, and
equal iteration counts and flags. The single-scenario case is held
against the golden fixture ``tests/golden/vsa_boxddp_T30.npz`` at
``tests/test_golden.py``'s tolerances.
"""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aslr_to_tpu.parallel.batch import make_batched_solver as jax_batched_solver
from aslr_to_tpu.solvers.ddp import SolverSettings as JaxSettings
from aslr_to_tpu.workloads.presets import two_dof_vsa_boxddp as jax_preset
from aslr_to_tpu_torch import SolverSettings, make_batched_solver, two_dof_vsa_boxddp
from aslr_to_tpu_torch.kernels import build

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "vsa_boxddp_T30.npz")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x0s(seed, scales):
    rng = np.random.default_rng(seed)
    return np.concatenate([s * rng.standard_normal((n, 8)) for n, s in scales])


CASES = {
    # T, x0s, settings
    "small": (12, _x0s(1, [(4, 0.05)]), dict(maxiter=6, th_stop=1e-7)),
    # th_stop between lane 1's stop trough (converges at iteration 3) and
    # every other lane's minimum: one lane freezes early, the rest run on
    "staggered": (10, _x0s(0, [(3, 0.02), (2, 0.3)]), dict(maxiter=18, th_stop=23.5)),
    # the benchmark's settings (warm 2-iteration BoxQPs) at a small size
    "bench_settings": (12, _x0s(2, [(4, 0.05)]),
                       dict(maxiter=6, th_stop=1e-5, boxqp_warm_iters=2)),
}


def _solve_port(T, x0s, settings):
    w = two_dof_vsa_boxddp(T=T, device="cpu")
    solve = make_batched_solver(w.problem, SolverSettings(**settings), use_gaps=False,
                                bounds=w.bounds, use_fast_path="lanes")
    build.reset_launches()
    res = solve(torch.tensor(x0s))
    assert sum(build.LAUNCHES.values()) == 0     # CPU tensors: plain versions only
    return res


@pytest.mark.parametrize("case", list(CASES) + ["golden_T30"])
def test_lane_solver_matches_jax(case):
    if case == "golden_T30":
        ref = np.load(GOLDEN)
        res = _solve_port(30, np.zeros((1, 8)), dict(maxiter=25, th_stop=1e-7))
        assert np.allclose(float(res.cost[0]), float(ref["cost"]), rtol=1e-8)
        assert np.allclose(res.us[0].numpy(), ref["us"], atol=1e-6)
        assert int(res.iterations[0]) == int(ref["iters"])
        return

    T, x0s, settings = CASES[case]
    jw = jax_preset(T=T)
    ref = jax_batched_solver(jw.problem, JaxSettings(**settings), use_gaps=False,
                             bounds=jw.bounds, use_fast_path=False)(jnp.asarray(x0s))
    res = _solve_port(T, x0s, settings)

    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_array_equal(res.diverged.numpy(), np.asarray(ref.diverged))
    assert np.allclose(res.cost.numpy(), np.asarray(ref.cost), rtol=1e-8)
    assert np.allclose(res.us.numpy(), np.asarray(ref.us), atol=1e-8)
    assert np.allclose(res.xs.numpy(), np.asarray(ref.xs), atol=1e-8)
    assert np.allclose(res.stop.numpy(), np.asarray(ref.stop), rtol=1e-6)
    assert np.allclose(res.reg.numpy(), np.asarray(ref.reg), rtol=1e-8)
    if case == "staggered":
        assert len(set(res.iterations.tolist())) > 1 and bool(res.converged.any())
