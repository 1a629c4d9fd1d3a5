"""The port's FDDP family end to end (FDDP, DDP, the quasi-static warm
start) against the JAX package; BoxFDDP is in
``tests/test_torch_lane_solver_boxfddp.py``.

Each case solves the same initial states (seeded numpy, float64) with the
port's lane solver (plain versions on the CPU) and with the JAX package's
``make_batched_solver(..., use_fast_path=False)``, i.e. ``jit(vmap(solve))``,
and holds them to the tolerances of ``tests/test_lane_solver.py::_check``
(``torch_lane_support.check_against_jax``). The cases are the port's counterparts of
``tests/test_lane_solver.py:65-102, 176-184``. The single-scenario SEA
case is held against the golden fixture ``tests/golden/sea_T40.npz`` at
``tests/test_golden.py:31-37``'s tolerances.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from aslr_to_tpu.parallel.batch import make_batched_solver as jax_batched_solver
from aslr_to_tpu.solvers.ddp import SolverSettings as JaxSettings
from aslr_to_tpu.workloads.presets import two_dof_sea as jax_sea
from aslr_to_tpu_torch import two_dof_sea
from torch_lane_support import check_against_jax, one_thread, solve_port, x0_batch  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "sea_T40.npz")


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
    res = solve_port(two_dof_sea(T=T, device="cpu").problem, None, x0s, settings, use_gaps,
                     warm)
    check_against_jax(res, ref)


def test_sea_golden_T40_warm_start():
    ref = np.load(GOLDEN)
    res = solve_port(two_dof_sea(T=40, device="cpu").problem, None, np.zeros((1, 8)),
                     dict(maxiter=60, th_stop=1e-7), use_gaps=True, warm_start=True)
    assert np.allclose(float(res.cost[0]), float(ref["cost"]), rtol=1e-8)
    assert np.allclose(res.us[0].numpy(), ref["us"], atol=1e-6)
    assert int(res.iterations[0]) == int(ref["iters"])
