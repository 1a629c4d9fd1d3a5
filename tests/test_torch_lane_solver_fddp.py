"""The port's FDDP family end to end (FDDP, DDP, the quasi-static warm
start) against the JAX package; BoxFDDP is in
``tests/test_torch_lane_solver_boxfddp.py``.

Each case solves the same initial states (seeded numpy, float64) with the
port's lane solver (plain versions on the CPU) and with the JAX package's
``make_batched_solver(..., use_fast_path=False)``, i.e. ``jit(vmap(solve))``,
and holds them to the tolerances of ``tests/test_lane_solver.py::_check``
(``check_against_jax`` below). The cases are the port's counterparts of
``tests/test_lane_solver.py:65-102, 176-184``. The single-scenario SEA
case is held against the golden fixture ``tests/golden/sea_T40.npz`` at
``tests/test_golden.py:31-37``'s tolerances.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aslr_to_tpu.parallel.batch import make_batched_solver as jax_batched_solver
from aslr_to_tpu.solvers.ddp import SolverSettings as JaxSettings
from aslr_to_tpu.workloads.presets import two_dof_sea as jax_sea
from aslr_to_tpu_torch import SolverSettings, make_batched_solver, two_dof_sea
from aslr_to_tpu_torch.kernels import build

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "sea_T40.npz")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def x0_batch(seed, n, scale):
    return scale * np.random.default_rng(seed).standard_normal((n, 8))


def solve_port(w, bounds, x0s, settings, use_gaps, warm_start=False):
    """The port's lane solve on CPU tensors; no kernel may launch."""
    solve = make_batched_solver(w.problem, SolverSettings(**settings), use_gaps=use_gaps,
                                bounds=bounds, warm_start=warm_start, use_fast_path="lanes")
    build.reset_launches()
    res = solve(torch.tensor(x0s))
    assert sum(build.LAUNCHES.values()) == 0
    return res


def check_against_jax(res, ref, atol=1e-8):
    """``tests/test_lane_solver.py::_check``: cost rtol 1e-8, xs and us
    ``atol``, stop rtol 1e-6, reg rtol 1e-8, iterations and flags equal."""
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_array_equal(res.diverged.numpy(), np.asarray(ref.diverged))
    assert np.allclose(res.cost.numpy(), np.asarray(ref.cost), rtol=1e-8)
    assert np.allclose(res.us.numpy(), np.asarray(ref.us), atol=atol)
    assert np.allclose(res.xs.numpy(), np.asarray(ref.xs), atol=atol)
    assert np.allclose(res.stop.numpy(), np.asarray(ref.stop), rtol=1e-6)
    assert np.allclose(res.reg.numpy(), np.asarray(ref.reg), rtol=1e-8)


CASES = {
    # T, x0s, settings, use_gaps, warm start
    "fddp_sea": (12, x0_batch(6, 4, 0.05), dict(maxiter=6, th_stop=1e-7), True, False),
    # large x0s: backtracking and the dVexp < 0 accept branch, the sign of
    # dx in the dv term
    "fddp_backtracking": (12, x0_batch(42, 8, 0.6), dict(maxiter=12, th_stop=1e-7),
                          True, False),
    "fddp_warm_start": (10, x0_batch(7, 3, 0.03), dict(maxiter=5, th_stop=1e-7), True, True),
    # DDP: K4 with zero gaps
    "ddp_unbounded": (10, x0_batch(8, 3, 0.05), dict(maxiter=5, th_stop=1e-7), False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fddp_family_matches_jax(case):
    T, x0s, settings, use_gaps, warm = CASES[case]
    ref = jax_batched_solver(jax_sea(T=T).problem, JaxSettings(**settings), use_gaps=use_gaps,
                             bounds=None, warm_start=warm,
                             use_fast_path=False)(jnp.asarray(x0s))
    res = solve_port(two_dof_sea(T=T, device="cpu"), None, x0s, settings, use_gaps, warm)
    check_against_jax(res, ref)


def test_sea_golden_T40_warm_start():
    ref = np.load(GOLDEN)
    res = solve_port(two_dof_sea(T=40, device="cpu"), None, np.zeros((1, 8)),
                     dict(maxiter=60, th_stop=1e-7), use_gaps=True, warm_start=True)
    assert np.allclose(float(res.cost[0]), float(ref["cost"]), rtol=1e-8)
    assert np.allclose(res.us[0].numpy(), ref["us"], atol=1e-6)
    assert int(res.iterations[0]) == int(ref["iters"])
