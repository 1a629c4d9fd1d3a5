"""The port's 7-DoF SEA solves against the JAX package's generic solve.

``seven_dof_sea`` (nx=28, nu=7) at T=5, B=3, maxiter 3: the port's lane
route (the kernels' plain versions on the CPU), cold and warm-started from
the quasi-static controls, against the JAX package's ``jit(vmap(solve))``
with ``use_gaps=True, bounds=None``, compiled once for both (the cold and
the warm lanes of one call). Tolerances as ``tests/test_lane_solver.py:
376-405``: cost rtol 1e-10, xs and us atol 1e-10, iterations and flags
equal. The helpers are in ``torch_ndof_support.py``, the 3-DoF solves in
``test_torch_ndof.py``.
"""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import pytest

from torch_ndof_support import check_solve, jax_reference, one_thread  # noqa: F401

SEVEN_DOF = (5, 3, dict(maxiter=3, th_stop=1e-9))       # T, B, settings


@pytest.fixture(scope="module")
def jax_seven_dof():
    return jax_reference("seven_dof_sea", *SEVEN_DOF)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_seven_dof_lane_solve_matches_jax_generic(jax_seven_dof, warm):
    check_solve("seven_dof_sea", *SEVEN_DOF, warm, "lanes", jax_seven_dof)
