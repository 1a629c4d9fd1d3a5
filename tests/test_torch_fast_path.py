"""K6, the one-trial rollout, and the per-scenario solver's fast path.

- ``rollout1_plain`` (K6's plain version) against the JAX package's
  ``solvers/ddp.py::_rollout`` under ``vmap`` — the reference
  ``tests/test_vsa_fast_path.py:51-72`` holds the Pallas kernel against —
  with the box (BoxDDP), with the gaps on the SEA arm (FDDP), and with box
  and gaps (BoxFDDP, the tight box of ``tests/test_lane_solver.py``), to
  1e-9 absolute;
- ``rollout1_plain`` equal to ``rollout2_plain``'s first trial, to the bit;
- the fast path (``make_batched_solver(..., use_fast_path=True)``, plain
  kernels on the CPU) against the JAX package's generic ``vmap(solve)``
  with equal iterations and flags, cost rtol 1e-8 and us atol 1e-8, as
  ``tests/test_vsa_fast_path.py:75-105`` does for BoxDDP and SEA FDDP.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aslr_to_tpu.parallel.batch import make_batched_solver as jax_batched_solver
from aslr_to_tpu.solvers.ddp import Bounds as JaxBounds
from aslr_to_tpu.solvers.ddp import SolverSettings as JaxSettings
from aslr_to_tpu.solvers.ddp import _rollout
from aslr_to_tpu.workloads.presets import two_dof_sea as jax_sea
from aslr_to_tpu.workloads.presets import two_dof_vsa_boxddp as jax_vsa
from aslr_to_tpu_torch import Bounds, SolverSettings, make_batched_solver, two_dof_sea
from aslr_to_tpu_torch import two_dof_vsa_boxddp
from aslr_to_tpu_torch.kernels import build
from aslr_to_tpu_torch.kernels.vsa_kernels import (
    build_fast_path,
    extract_vsa_spec,
    rollout1,
    rollout2_plain,
    supports_fast_path,
)
from aslr_to_tpu_torch.models.costs import ActivationModelQuad, CostModelResidual
from aslr_to_tpu_torch.models.costs import ResidualModelControl

T, B = 8, 8
TIGHT_BOX = ([-2.0, -2.0, 0.0, 0.0], [2.0, 2.0, 3.0, 3.0])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lanes(a):
    return torch.tensor(np.moveaxis(np.asarray(a), 0, -1).copy())


def _arm(variant):
    """(JAX problem, JAX bounds, port problem, port bounds, use_gaps, nu)."""
    if variant == "sea_gaps":
        return jax_sea(T=T).problem, None, two_dof_sea(T=T, device="cpu").problem, None, True, 2
    jw, tw = jax_vsa(T=T), two_dof_vsa_boxddp(T=T, device="cpu")
    if variant == "vsa_box":
        return jw.problem, jw.bounds, tw.problem, tw.bounds, False, 4
    return (jw.problem, JaxBounds(*map(jnp.array, TIGHT_BOX)), tw.problem,
            Bounds(*(torch.tensor(b, dtype=torch.float64) for b in TIGHT_BOX)), True, 4)


def _trial_inputs(nu, seed):
    # small enough that no trajectory leaves the region where the
    # rollout is well conditioned (the 1e-3 motor inertia amplifies torques)
    rng = np.random.default_rng(seed)
    scale = np.array([0.05, 0.05, 2.0, 2.0])[:nu]
    us = rng.standard_normal((B, T, nu)) * scale
    if nu == 4:
        us[..., 2:] = np.abs(us[..., 2:])
    return dict(x0=0.1 * rng.standard_normal((B, 8)), xs=0.1 * rng.standard_normal((B, T + 1, 8)),
                us=us, k=0.05 * rng.standard_normal((B, T, nu)),
                K=0.01 * rng.standard_normal((B, T, nu, 8)),
                fs=0.05 * rng.standard_normal((B, T + 1, 8)),
                infeas=(np.arange(B) % 3 != 0), alpha=0.5 ** (np.arange(B) % 4))


@pytest.mark.parametrize("variant", ["vsa_box", "sea_gaps", "vsa_box_gaps"])
def test_rollout1_plain_matches_jax_rollout(variant):
    jp, jb, tp, tb, gaps, nu = _arm(variant)
    d = _trial_inputs(nu, seed=3)

    def ref_one(x0, xs, us, k, K, fs, alpha, on):
        return _rollout(dataclasses.replace(jp, x0=x0), xs, us, k, K, fs, alpha, on, gaps, jb)

    xs_j, us_j, cost_j = jax.jit(jax.vmap(ref_one))(*map(jnp.asarray, (
        d["x0"], d["xs"], d["us"], d["k"], d["K"], d["fs"], d["alpha"], d["infeas"])))
    spec = extract_vsa_spec(tp, tb)
    wterm = torch.full((B,), spec.w_goal_term, dtype=torch.float64)
    box = (None, None)
    if spec.lb is not None:
        box = tuple(torch.tensor(b)[:, None].expand(nu, B).contiguous() for b in (spec.lb, spec.ub))
    gap_args = (_lanes(d["fs"]), torch.tensor(d["infeas"], dtype=torch.float64)) if gaps else ()
    args = (spec, _lanes(d["xs"]), _lanes(d["us"]), _lanes(d["k"]), _lanes(d["K"]),
            _lanes(d["x0"]), torch.tensor(d["alpha"]), wterm, *box, *gap_args)
    build.reset_launches()
    trial = rollout1(*args)                 # CPU tensors: the plain version
    assert sum(build.LAUNCHES.values()) == 0
    np.testing.assert_allclose(np.moveaxis(trial.xs.numpy(), -1, 0), xs_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.moveaxis(trial.us.numpy(), -1, 0), us_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(trial.cost.numpy(), cost_j, rtol=1e-12, atol=1e-9)

    # K6 is K3 with one trial: rollout2's first trial at the same alpha
    first, _ = rollout2_plain(*args[:7], 0.5 * args[6], *args[7:])
    assert torch.equal(trial.xs, first.xs) and torch.equal(trial.us, first.us)
    assert torch.equal(trial.cost, first.cost)


FAST_CASES = {
    # as tests/test_vsa_fast_path.py:75-105: arm, use_gaps, x0 scale, settings
    "boxddp": ("vsa", False, 0.05, dict(maxiter=6, th_stop=1e-7)),
    "sea_fddp": ("sea", True, 0.1, dict(maxiter=8, th_stop=1e-9)),
}


@pytest.mark.parametrize("case", list(FAST_CASES))
def test_fast_path_matches_jax_generic_solve(case):
    arm, use_gaps, scale, settings = FAST_CASES[case]
    x0s = scale * np.random.default_rng(1).standard_normal((4, 8))
    if arm == "vsa":
        jw, tw = jax_vsa(T=12), two_dof_vsa_boxddp(T=12, device="cpu")
    else:
        jw, tw = jax_sea(T=12), two_dof_sea(T=12, device="cpu")
    ref = jax_batched_solver(jw.problem, JaxSettings(**settings), use_gaps=use_gaps,
                             bounds=jw.bounds, use_fast_path=False)(jnp.asarray(x0s))
    build.reset_launches()
    res = make_batched_solver(tw.problem, SolverSettings(**settings), use_gaps=use_gaps,
                              bounds=tw.bounds, use_fast_path=True)(torch.tensor(x0s))
    assert sum(build.LAUNCHES.values()) == 0
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_array_equal(res.diverged.numpy(), np.asarray(ref.diverged))
    assert np.allclose(res.cost.numpy(), np.asarray(ref.cost), rtol=1e-8)
    assert np.allclose(res.us.numpy(), np.asarray(ref.us), atol=1e-8)


def test_fast_path_names_what_it_does_not_take():
    """An unsupported cost raises a TypeError naming it; nothing falls back."""
    w = two_dof_vsa_boxddp(T=4, device="cpu")
    d = w.problem.running.differential
    extra = CostModelResidual(d.state, ActivationModelQuad(), ResidualModelControl(d.state, 4))
    odd = dataclasses.replace(d.costs, items=d.costs.items + (
        dataclasses.replace(d.costs.items[0], cost=dataclasses.replace(
            extra, activation=object())),))
    p = dataclasses.replace(w.problem, running=dataclasses.replace(
        w.problem.running, differential=dataclasses.replace(d, costs=odd)))
    ok, reason = supports_fast_path(p, w.bounds)
    assert not ok and "unsupported activation" in reason
    with pytest.raises(TypeError, match="unsupported activation"):
        build_fast_path(p, w.bounds)
    with pytest.raises(TypeError, match="unsupported activation"):
        make_batched_solver(p, SolverSettings(maxiter=1), use_gaps=False, bounds=w.bounds,
                            use_fast_path=True)
    assert supports_fast_path(w.problem, w.bounds) == (True, "")


# lane 3 of chip_smoke's generic parity inputs on the card (measure.x0_batch(64,
# float64, seed=1)): the one lane whose generic and fast costs part there
TIE_X0 = [-0.04297752460840816, 0.034963995728248314, -0.051637270500705684,
          -0.07238023021349398, 0.02627283322143751, 0.04192598237761758,
          0.022264361253443974, -0.0814797556563205]


def test_fast_and_generic_part_only_at_a_bound_tie():
    """That lane (T=40, the tight box, cold QPs) through the generic and
    fast routes on the CPU: the logs of the first three iterations agree and
    the iterates after them differ by rounding only, yet some controls sit on
    a bound of the box in one route and an ulp inside it in the other (the
    rollouts sum the feedback in different orders). The BoxQP's clamped set
    is a discrete function of that, so the fourth backward parts by more
    than 1e-3, and the lane runs to maxiter on two different paths.
    chip_smoke's ``explain_parting`` prints the same on the card."""
    f64 = torch.float64
    w = two_dof_vsa_boxddp(T=40, device="cpu")
    box = Bounds(*(torch.tensor(b, dtype=f64) for b in TIGHT_BOX))
    x0 = torch.tensor([TIE_X0], dtype=f64)

    def run(maxiter):
        s = SolverSettings(maxiter=maxiter, th_stop=1e-5)
        return [make_batched_solver(w.problem, s, use_gaps=False, bounds=box, keep_log=True,
                                    use_fast_path=route)(x0) for route in (False, True)]

    g, f = run(3)
    for a, b in ((g.xs, f.xs), (g.us, f.us)):
        assert float((a - b).abs().max()) <= 1e-12 * float(a.abs().max())
    on_g = (g.us == box.lb) | (g.us == box.ub)
    on_f = (f.us == box.lb) | (f.us == box.ub)
    tie = on_g != on_f
    assert bool(tie.any())
    assert float((g.us - f.us)[tie].abs().max()) <= 2 * torch.finfo(f64).eps * 2.0
    g, f = run(4)
    for field in ("costs", "stops", "steps"):
        a, b = getattr(g.log, field)[0], getattr(f.log, field)[0]
        np.testing.assert_allclose(a[:3].numpy(), b[:3].numpy(), rtol=1e-9)
    assert abs(float(g.log.stops[0, 3] / f.log.stops[0, 3]) - 1.0) > 1e-3
