"""The 3-DoF SEA arm's DDP and BoxFDDP on the port's lane and fast routes
against the JAX package's generic solve.

``three_dof_sea`` (nx=12, nu=3) at T=8, B=4, maxiter 5, float64 on the CPU
(the kernels' plain versions): DDP (``use_gaps=False``, no box) and BoxFDDP
(``use_gaps=True``) in the box ``BOX``, ±0.5 on every torque, which the
quasi-static controls and the solves' controls cross, with cold QPs
(``boxqp_warm_iters=0``: warm QPs part the generic and the kernel routes
at 1e-6, ROADMAP), each cold and warm-started from the quasi-static
controls, held to the JAX package's ``jit(vmap(solve))`` with the same
``Bounds`` (what ``make_batched_solver(..., use_fast_path=False)`` runs;
one compiled reference a family takes the problem and the bounds as
arguments). Tolerances: iterations and flags equal, cost rtol 1e-10; xs and
us atol 1e-10 for DDP (``tests/test_lane_solver.py:376-405``) and 1e-6 for
BoxFDDP (the masked BoxQP under the gap deflection is ill-conditioned at
reg=1e-9, as in ``test_torch_lane_solver_boxfddp.py``). The 7-DoF BoxFDDP
case is in ``test_torch_ndof_box_seven.py``, so that another worker
compiles it. The helpers are in ``torch_ndof_support.py``.
"""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

from torch_ndof_support import box_reference, check_box_solve, one_thread  # noqa: F401

T, B = 8, 4
SETTINGS = dict(maxiter=5, th_stop=1e-9, boxqp_warm_iters=0)
BOX = ([-0.5] * 3, [0.5] * 3)
FAMILIES = {"ddp": (False, None, 1e-10), "boxfddp": (True, BOX, 1e-6)}


@pytest.fixture(scope="module")
def references():
    return {name: box_reference("three_dof_sea", T, B, SETTINGS, gaps, box)
            for name, (gaps, box, _) in FAMILIES.items()}


@pytest.mark.parametrize("route", ["lanes", True], ids=["lanes", "fast"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_three_dof_ddp_and_boxfddp_match_jax_generic(references, family, warm, route):
    gaps, box, atol = FAMILIES[family]
    res = check_box_solve("three_dof_sea", T, B, SETTINGS, gaps, box, warm, route,
                          references[family], atol)
    if box is not None:         # the box binds: final controls on a bound
        us = res.us.numpy()
        assert np.isin(us, np.asarray(box)).any()
