"""Per-knot problems in the port against the JAX package (float64, CPU).

The port's counterparts of ``tests/test_lane_per_knot.py`` and
``tests/test_per_knot.py``: a problem whose frame target moves from knot to
knot (the tracking MPC of ``examples/mpc_tracking.py``, built by
``stack_knots``) and ``[T, nu]`` control boxes, solved by the port's lane,
fast and generic routes (the kernels' plain versions on the CPU) and held
to the JAX package's generic ``jit(vmap(solve))`` on the same per-knot
problem at ``torch_lane_support.check_against_jax``'s tolerances (cost rtol
1e-8, xs and us atol 1e-8, stop rtol 1e-6, iterations and flags equal).
The JAX reference takes the problem as an argument, so that problems of one
structure share its compiled solve. The target and the box together hold xs
and us to atol 1e-6: ``tests/test_lane_per_knot.py:131-138`` traces that to
the reg=1e-9 QP amplifying the goal Jacobian's roundoff on near-zero torques.
The initial states are those of ``tests/test_lane_per_knot.py`` (its PRNG
keys 11-14). In the tight box the lane route's BoxQPs run all their
iterations and the generic route's stop at convergence, as in the JAX
package, so on other states the two routes may part by more than 1e-8 in
us; they then part in the JAX package too (its lane solver against its
generic one), and the port's lane route stays equal to the JAX lane
solver's.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aslr_to_tpu.ops.se3 import SE3 as JaxSE3
from aslr_to_tpu.pallas.vsa_kernels import extract_vsa_spec as jax_extract_spec
from aslr_to_tpu.solvers import ddp as jax_ddp
from aslr_to_tpu.solvers.problem import stack_knots as jax_stack_knots
from aslr_to_tpu.workloads import presets as jax_presets
from aslr_to_tpu_torch import Bounds, SolverSettings, make_batched_solver, stack_knots
from aslr_to_tpu_torch import two_dof_sea, two_dof_vsa_boxddp, two_dof_vsa_modified
from aslr_to_tpu_torch.convert import spec_from_numpy
from aslr_to_tpu_torch.kernels.vsa_kernels import extract_vsa_spec, supports_fast_path
from aslr_to_tpu_torch.measure import mpc_target
from aslr_to_tpu_torch.solvers.ddp import _linearize_core
from aslr_to_tpu_torch.workloads.presets import with_frame_targets
from torch_lane_support import check_against_jax, one_thread, solve_port, x0_batch  # noqa: F401

BOX = ([-2.0, -2.0, 0.0, 0.0], [2.0, 2.0, 3.0, 3.0])
SETTINGS = dict(maxiter=6, th_stop=1e-7)


@partial(jax.jit, static_argnames=("settings", "use_gaps"))
def _jax_solve(problem, bounds, x0s, settings, use_gaps):
    """The JAX package's generic solve of ``problem`` from each x0
    (``parallel/batch.py::make_batched_solver(use_fast_path=False)``)."""
    def one(x0):
        p = dataclasses.replace(problem, x0=x0)
        return jax_ddp.solve(p, jnp.broadcast_to(x0, (p.T + 1,) + x0.shape), None,
                             settings=settings, use_gaps=use_gaps, bounds=bounds)
    return jax.vmap(one)(x0s)


def jax_reference(problem, bounds, x0s, settings, use_gaps):
    jb = None if bounds is None else jax_ddp.Bounds(*(jnp.asarray(b) for b in bounds))
    return _jax_solve(problem, jb, jnp.asarray(x0s), jax_ddp.SolverSettings(**settings),
                      use_gaps)


def jax_x0s(key, n=4):
    """0.05 randn [n, 8] from the JAX PRNG key of tests/test_lane_per_knot.py."""
    return np.asarray(0.05 * jax.random.normal(jax.random.PRNGKey(key), (n, 8)))


def targets(T, sweep):
    """[T, 3, 3] and [T, 3]: knot t's target at [0.01, 0.05 + sweep t / T, 0.18]."""
    return (np.tile(np.eye(3), (T, 1, 1)),
            np.stack([[0.01, 0.05 + sweep * t / T, 0.18] for t in range(T)]))


def jax_with_targets(problem, rot, trans):
    """``tests/test_lane_per_knot.py::_with_moving_target`` from target arrays."""
    base = problem.running

    def at_knot(t):
        diff = base.differential
        items = []
        for it in diff.costs.items:
            c = it.cost
            if hasattr(c, "residual") and hasattr(c.residual, "placement"):
                res = dataclasses.replace(c.residual, placement=JaxSE3(jnp.asarray(rot[t]),
                                                                       jnp.asarray(trans[t])))
                c = dataclasses.replace(c, residual=res)
            items.append(dataclasses.replace(it, cost=c))
        costs = dataclasses.replace(diff.costs, items=tuple(items))
        return dataclasses.replace(base, differential=dataclasses.replace(diff, costs=costs))

    running = jax_stack_knots([at_knot(t) for t in range(problem.T)])
    return dataclasses.replace(problem, running=running, per_knot=True)


def box_table(T, pinch=None, stiff=None):
    """[T, 4] tables of the tight box; ``pinch``: knots whose torques are
    held to +-0.05; ``stiff``: knots whose stiffness bound drops to 1.5."""
    lb, ub = (np.tile(np.asarray(b), (T, 1)) for b in BOX)
    for t in pinch or ():
        lb[t, :2], ub[t, :2] = -0.05, 0.05
    for t in stiff or ():
        ub[t, 2:] = 1.5
    return lb, ub


def port_bounds(table):
    return Bounds(*(torch.tensor(b) for b in table))


@pytest.fixture(scope="module")
def mpc():
    """(a): the SEA arm tracking a moving target, FDDP, T=12, B=4."""
    T = 12
    rot, trans = targets(T, 0.15)
    jp = jax_with_targets(jax_presets.two_dof_sea(T=T).problem, rot, trans)
    x0s = jax_x0s(11)
    ref = jax_reference(jp, None, x0s, SETTINGS, True)
    return with_frame_targets(two_dof_sea(T=T, device="cpu").problem, rot, trans), x0s, ref


@pytest.mark.parametrize("route", ["lanes", True, False])
def test_mpc_tracking_matches_jax(mpc, route):
    problem, x0s, ref = mpc
    assert not np.all(np.asarray(ref.diverged))
    res = solve_port(problem, None, x0s, SETTINGS, True, route=route)
    check_against_jax(res, ref)


def test_mpc_target_is_the_example_sweep():
    """measure.py's target (the chip's MPC path) is examples/mpc_tracking.py's."""
    _, trans = targets(60, 0.15)
    assert np.array_equal(np.stack([mpc_target(t, 60) for t in range(60)]), trans)


BOX_CASES = {
    # (b) BoxDDP with knot T//2's torques pinched; (d) the pinched box and a
    # moving target together; (c) BoxFDDP, stiffness bound lowered at 2-4;
    # each with its PRNG key and maxiter of tests/test_lane_per_knot.py
    "boxddp_pinched": (False, dict(pinch=[5]), None, 1e-8, 12, 6),
    "target_and_box": (False, dict(pinch=[5]), 0.1, 1e-6, 14, 6),
    "boxfddp": (True, dict(stiff=[2, 3, 4]), None, 1e-8, 13, 5),
}


@pytest.mark.parametrize("case", list(BOX_CASES))
def test_per_knot_box_matches_jax(case):
    use_gaps, pinch, sweep, atol, key, maxiter = BOX_CASES[case]
    settings = dict(SETTINGS, maxiter=maxiter)
    T = 10
    table = box_table(T, **pinch)
    jp = jax_presets.two_dof_vsa_boxddp(T=T).problem
    problem = two_dof_vsa_boxddp(T=T, device="cpu").problem
    if sweep is None:
        jp = dataclasses.replace(jp, running=jax_stack_knots([jp.running] * T), per_knot=True)
        problem = dataclasses.replace(problem, running=stack_knots([problem.running] * T),
                                      per_knot=True)
    else:
        rot, trans = targets(T, sweep)
        jp = jax_with_targets(jp, rot, trans)
        problem = with_frame_targets(problem, rot, trans)
    x0s = jax_x0s(key)
    ref = jax_reference(jp, table, x0s, settings, use_gaps)
    res = solve_port(problem, port_bounds(table), x0s, settings, use_gaps)
    if pinch.get("pinch"):      # the pinched knot's QPs clamp
        assert bool((res.us[:, T // 2, :2].abs() == 0.05).any())
    check_against_jax(res, ref, atol)


def test_varying_weight_names_the_knot_constant_rule():
    """(e) Only the frame target and the box may vary per knot: a varying
    cost weight keeps the problem off the kernels with the JAX package's
    reason, and the generic route still solves it."""
    T = 8
    w = two_dof_sea(T=T, device="cpu")
    base = w.problem.running

    def with_weight(t):
        diff = base.differential
        items = tuple(dataclasses.replace(it, weight=it.weight * (1.0 + 0.1 * t))
                      for it in diff.costs.items)
        costs = dataclasses.replace(diff.costs, items=items)
        return dataclasses.replace(base, differential=dataclasses.replace(diff, costs=costs))

    problem = dataclasses.replace(w.problem, running=stack_knots([with_weight(t)
                                                                  for t in range(T)]),
                                  per_knot=True)
    ok, reason = supports_fast_path(problem, None)
    assert not ok
    assert "knot-constant" in reason
    for route in ("lanes", True):
        with pytest.raises(TypeError, match="knot-constant"):
            make_batched_solver(problem, SolverSettings(maxiter=2), use_fast_path=route)
    res = solve_port(problem, None, x0_batch(3, 2, 0.05), dict(maxiter=2), True, route=False)
    assert bool(torch.isfinite(res.cost).all())


def test_box_ub_needs_a_shared_box():
    """(f) The bound continuation ``box_ub`` takes a shared box only."""
    T = 8
    w = two_dof_vsa_boxddp(T=T, device="cpu")
    problem = dataclasses.replace(w.problem, running=stack_knots([w.problem.running] * T),
                                  per_knot=True)
    solve = make_batched_solver(problem, SolverSettings(maxiter=2), use_gaps=False,
                                bounds=port_bounds(box_table(T)), use_fast_path="lanes")
    with pytest.raises(ValueError, match="shared"):
        solve(torch.zeros(2, 8, dtype=torch.float64), box_ub=w.bounds.ub)


@pytest.mark.parametrize("route", ["lanes", False])
def test_identical_stack_solves_like_the_shared_model(route):
    """(g) A per-knot problem whose knots are all one model, with a [T, nu]
    box whose rows are all the shared box, solves to the bit like the
    shared problem (the port alone, as tests/test_per_knot.py:66-77)."""
    T = 6
    w = two_dof_vsa_boxddp(T=T, device="cpu")
    stacked = dataclasses.replace(w.problem, running=stack_knots([w.problem.running] * T),
                                  per_knot=True)
    table = box_table(T)
    x0s = x0_batch(5, 3, 0.05)
    ref = solve_port(w.problem, port_bounds(BOX), x0s, SETTINGS, False, route=route)
    res = solve_port(stacked, port_bounds(table), x0s, SETTINGS, False, route=route)
    for name in ("xs", "us", "cost", "stop", "iterations", "converged", "diverged"):
        assert torch.equal(getattr(res, name), getattr(ref, name)), name


def test_per_knot_spec_matches_jax():
    """(h) The port's spec of a per-knot problem (a moving target and a
    [T, nu] box) equals the JAX package's, carried across by
    ``convert.spec_from_numpy``; the port's problem is built from the JAX
    problem's stacked target leaves as numpy."""
    T = 10
    rot, trans = targets(T, 0.1)
    jp = jax_with_targets(jax_presets.two_dof_vsa_boxddp(T=T).problem, rot, trans)
    table = box_table(T, pinch=[5])
    jspec = jax_extract_spec(jp, jax_ddp.Bounds(*(jnp.asarray(b) for b in table)))
    leaf = jp.running.differential.costs.items[0].cost.residual.placement
    problem = with_frame_targets(two_dof_vsa_boxddp(T=T, device="cpu").problem,
                                 np.asarray(leaf.rot), np.asarray(leaf.trans))
    spec = extract_vsa_spec(problem, port_bounds(table))
    carried = spec_from_numpy(jspec._asdict())
    assert spec.per_knot_target and spec.per_knot_box
    assert carried.per_knot_target and carried.per_knot_box
    for dtype in (np.float64, torch.float32):
        assert np.array_equal(spec.target_table(T, dtype), carried.target_table(T, dtype))
        assert np.array_equal(spec.target_table(T, dtype), jspec.target_table(
            T, np.float64 if dtype is np.float64 else np.float32))
    for name in ("target_rot_inv", "target_pos", "lb", "ub", "term_target_rot_inv",
                 "term_target_pos", "xw", "uw", "binv"):
        assert np.array_equal(getattr(spec, name), getattr(carried, name)), name
    for name in ("dt", "w_goal", "w_goal_term", "stiff_w", "frame_id", "variant", "nu", "nl"):
        assert getattr(spec, name) == getattr(carried, name), name
    # a shared target folds: every row equal gives the spec a [3, 3] target
    flat = with_frame_targets(two_dof_sea(T=T, device="cpu").problem, *targets(T, 0.0))
    assert not extract_vsa_spec(flat, None).per_knot_target


def test_vsa_modified_preset_matches_jax():
    """``two_dof_vsa_modified`` (the stiffness cost, k_lb = 0.002): cost and
    derivatives of the port's generic linearization at one iterate equal the
    JAX preset's to 1e-12."""
    T = 3
    rng = np.random.default_rng(7)
    xs = 0.1 * rng.standard_normal((1, T + 1, 8))
    us = np.concatenate([rng.standard_normal((1, T, 2)),
                         1.0 + np.abs(rng.standard_normal((1, T, 2)))], axis=-1)
    jw = jax_presets.two_dof_vsa_modified(T=T)
    cost, run, term, _ = jax.jit(jax_ddp._linearize_core)(jw.problem, jnp.asarray(xs[0]),
                                                           jnp.asarray(us[0]))
    w = two_dof_vsa_modified(T=T, device="cpu")
    assert np.array_equal(w.bounds.lb.numpy(), np.asarray(jw.bounds.lb))
    pcost, prun, pterm, _, ok = _linearize_core(w.problem, torch.tensor(xs), torch.tensor(us))
    assert bool(ok.all())
    np.testing.assert_allclose(pcost.numpy()[0], np.asarray(cost), rtol=1e-12)
    for name in prun._fields:
        np.testing.assert_allclose(getattr(prun, name).numpy()[0], np.asarray(getattr(run, name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(getattr(pterm, name).numpy()[0],
                                   np.asarray(getattr(term, name)), rtol=1e-12, atol=1e-12,
                                   err_msg=name)
