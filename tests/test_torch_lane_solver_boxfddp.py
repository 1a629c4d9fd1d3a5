"""The port's BoxFDDP end to end (gaps and a control box: K5's masked
BoxQP gains, clamped gap-contracting rollouts) against the JAX package.

The port's counterparts of ``tests/test_lane_solver.py:114-140``, in the
tight box of ``_tight_bounds`` there (in the preset's wide box the first
infeasibility-resolving rollout is chaotic), at
``tests/torch_lane_support.py::check_against_jax``'s tolerances
with xs and us atol 1e-6, as there: the masked BoxQP under the gap
deflection is ill-conditioned at reg=1e-9.
"""
import jax.numpy as jnp
import pytest
import torch

from aslr_to_tpu.parallel.batch import make_batched_solver as jax_batched_solver
from aslr_to_tpu.solvers.ddp import Bounds as JaxBounds
from aslr_to_tpu.solvers.ddp import SolverSettings as JaxSettings
from aslr_to_tpu.workloads.presets import two_dof_vsa_boxddp as jax_vsa
from aslr_to_tpu_torch import Bounds, two_dof_vsa_boxddp
from torch_lane_support import check_against_jax, one_thread, solve_port, x0_batch  # noqa: F401

TIGHT_BOX = ([-2.0, -2.0, 0.0, 0.0], [2.0, 2.0, 3.0, 3.0])


CASES = {
    # x0s, settings
    "boxfddp": (x0_batch(9, 4, 0.05), dict(maxiter=5, th_stop=1e-7)),
    # large x0s: backtracking and the dVexp < 0 accept branch
    "boxfddp_backtracking": (x0_batch(10, 6, 0.5), dict(maxiter=10, th_stop=1e-7)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_boxfddp_matches_jax(case):
    x0s, settings = CASES[case]
    T = 10
    jb = JaxBounds(lb=jnp.array(TIGHT_BOX[0]), ub=jnp.array(TIGHT_BOX[1]))
    ref = jax_batched_solver(jax_vsa(T=T).problem, JaxSettings(**settings), use_gaps=True,
                             bounds=jb, use_fast_path=False)(jnp.asarray(x0s))
    tb = Bounds(*(torch.tensor(b, dtype=torch.float64) for b in TIGHT_BOX))
    res = solve_port(two_dof_vsa_boxddp(T=T, device="cpu").problem, tb, x0s, settings,
                     use_gaps=True)
    check_against_jax(res, ref, atol=1e-6)
