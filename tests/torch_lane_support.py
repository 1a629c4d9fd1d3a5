"""Helpers of the tests that hold the port's solves against the JAX
package: seeded initial states, the port's lane solve on CPU tensors, and
the tolerances of ``tests/test_lane_solver.py::_check``. Shared by
``test_torch_lane_solver_fddp.py``, ``test_torch_lane_solver_boxfddp.py``
and ``test_torch_per_knot.py``.
"""
import numpy as np
import pytest
import torch

from aslr_to_tpu_torch import SolverSettings, make_batched_solver
from aslr_to_tpu_torch.kernels import build


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Imported into a test module: its tests run on one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def x0_batch(seed, n, scale, nx=8):
    return scale * np.random.default_rng(seed).standard_normal((n, nx))


def solve_port(problem, bounds, x0s, settings, use_gaps, warm_start=False, route="lanes"):
    """The port's solve of ``problem`` (a workload's problem) on CPU tensors
    by ``route`` (``use_fast_path``); no kernel may launch."""
    solve = make_batched_solver(problem, SolverSettings(**settings), use_gaps=use_gaps,
                                bounds=bounds, warm_start=warm_start, use_fast_path=route)
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
