"""The 7-DoF SEA arm's BoxFDDP on the port's lane route against the JAX
package's generic solve.

``seven_dof_sea`` (nx=28, nu=7) at T=5, B=3, maxiter 3, float64 on the CPU
(the kernels' plain versions), warm-started from the quasi-static controls,
in the torque box of the ``sevendof_box`` path (``measure.py::
SEVENDOF_BOX``), which those controls cross, with cold QPs
(``boxqp_warm_iters=0``), held to the JAX package's ``jit(vmap(solve))``
with the same ``Bounds``: iterations and flags equal, cost rtol 1e-10, xs
and us atol 1e-6 (as ``test_torch_ndof_box.py``). A file of its own, so
that another worker compiles its reference (45-65 s at the 7-DoF shapes).
"""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

from aslr_to_tpu_torch.measure import SEVENDOF_BOX
from torch_ndof_support import box_reference, check_box_solve, one_thread  # noqa: F401

T, B = 5, 3
SETTINGS = dict(maxiter=3, th_stop=1e-9, boxqp_warm_iters=0)
BOX = (list(-np.asarray(SEVENDOF_BOX)), list(SEVENDOF_BOX))


@pytest.fixture(scope="module")
def jax_seven_box():
    return box_reference("seven_dof_sea", T, B, SETTINGS, True, BOX)


def test_seven_dof_boxfddp_lane_solve_matches_jax_generic(jax_seven_box):
    res = check_box_solve("seven_dof_sea", T, B, SETTINGS, True, BOX, True, "lanes",
                          jax_seven_box, 1e-6)
    assert np.isin(res.us.numpy(), np.asarray(BOX)).any()     # the box binds
