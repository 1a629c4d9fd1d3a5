"""The n-DoF SEA chains of the port against the JAX package: the 7-DoF arm's
rigid-body dynamics, the 3- and 7-DoF SEA presets' models, and their solves.

Seeded numpy inputs (float64) go through the JAX function and the port's:

- ``robots.seven_dof_arm``: forward kinematics, the gripper's placement,
  RNEA, the mass matrix and ``rnea_derivatives`` at random (q, v, a), to
  1e-12 relative to each quantity's largest entry; ``robots.load``;
- the lane twins of the kernels' device library (``ops/lanes.py``:
  ``rnea_lanes``, ``mass_nle_lanes``, ``choln``, ``choln_solve``,
  ``solven``) on the 3- and 7-DoF chains, to 1e-12;
- ``three_dof_sea`` and ``seven_dof_sea``: ``calc_with_diff`` of the
  running and terminal models (the Euler step and cost from the SEA
  dynamics' ``calc``, their derivatives from its ``calc_diff``) along a
  random trajectory, and ``quasi_static``, to 1e-10 (derivatives by forward mode
  through the same closed forms, summed in another order);
- the solves: the port's lane and fast routes (the kernels' plain
  versions on the CPU) cold and warm-started on ``three_dof_sea`` (T=8,
  B=4, maxiter 5; the 7-DoF solves are in ``test_torch_ndof_seven.py``,
  so that another worker runs them), against the JAX package's generic
  ``jit(vmap(solve))`` with ``use_gaps=True, bounds=None`` (what
  ``make_batched_solver(..., use_fast_path=False)`` runs; the cold and the
  warm solves of one preset share one compiled reference). Tolerances as
  ``tests/test_lane_solver.py:376-405`` (the 3-DoF lane test of the JAX
  package): cost rtol 1e-10, xs and us atol 1e-10, iterations and flags
  equal. Above 2 DoF the lane route's mass
  solve is an unrolled Cholesky and the generic route's an LU solve, so the
  two agree to a tolerance, not to the bit.

Each JAX reference is compiled once (one compiled function per test, the
solves' in a fixture).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aslr_to_tpu.models import robots as jrobots
from aslr_to_tpu.ops import lanes as jlanes
from aslr_to_tpu.ops import rigid_body as jrbd
from aslr_to_tpu_torch.models import robots
from aslr_to_tpu_torch.ops import lanes as tlanes
from aslr_to_tpu_torch.ops import rigid_body as trbd
from torch_ndof_support import PRESETS, check_solve, jax_reference, one_thread  # noqa: F401

N = 5


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _t(a):
    return torch.tensor(np.asarray(a))


def test_seven_dof_arm_matches_jax():
    jrob, trob = jrobots.seven_dof_arm(), robots.seven_dof_arm()
    fid = jrob.frame_id("gripper")
    assert trob.frame_id("gripper") == fid and trob.parents == jrob.parents
    rng = np.random.default_rng(0)
    q, v, a = (rng.standard_normal((N, 7)) for _ in range(3))

    def jax_all(q_, v_, a_):    # one compiled function for every quantity
        M = jrbd.frame_placement(jrob, q_, fid)
        return (jrbd.forward_kinematics(jrob, q_), M.rot, M.trans, jrbd.rnea(jrob, q_, v_, a_),
                jrbd.mass_matrix(jrob, q_), jrbd.rnea_derivatives(jrob, q_, v_, a_))

    (jrots, jtrans), jR, jp, jtau, jM, (jdq, jdv) = jax.jit(jax.vmap(jax_all))(q, v, a)
    trots, ttrans = trbd.forward_kinematics(trob, _t(q))
    for want, got in zip(list(jrots) + list(jtrans), list(trots) + list(ttrans)):
        _close(got.numpy(), want, 1e-12)
    tM = trbd.frame_placement(trob, _t(q), fid)
    _close(tM.rot.numpy(), jR, 1e-12)
    _close(tM.trans.numpy(), jp, 1e-12)
    _close(trbd.rnea(trob, _t(q), _t(v), _t(a)).numpy(), jtau, 1e-12)
    _close(trbd.mass_matrix(trob, _t(q)).numpy(), jM, 1e-12)
    tdq, tdv = trbd.rnea_derivatives(trob, _t(q), _t(v), _t(a))
    _close(tdq.numpy(), jdq, 1e-12)
    _close(tdv.numpy(), jdv, 1e-12)


def test_load_names_the_robots_it_has():
    assert robots.load("seven_dof_arm").name == "seven_dof_arm"
    assert robots.load("asr_twodof", device="cpu").nq == 2
    pendulum = robots.load("double_pendulum", dtype=torch.float32)
    assert pendulum.name == "double_pendulum" and pendulum.frame_names == ("tip",)
    assert pendulum.mass.dtype == torch.float32
    with pytest.raises(KeyError, match="available: \\['asr_twodof', 'double_pendulum', "
                                       "'seven_dof_arm'\\]"):
        robots.load("no_such_robot")


@pytest.mark.parametrize("name", list(PRESETS))
def test_ndof_lane_dynamics_match_jax(name):
    """The lane twins of the kernels' device library at nl = 3 and 7:
    rnea_lanes, mass_nle_lanes, the unrolled Cholesky (choln, choln_solve)
    and solven, eager on lanes of 9 scenarios, against JAX ops/lanes.py."""
    jfn, tfn, nl = PRESETS[name]
    jrc = jlanes.RobotConsts(jfn(T=2).problem.state.robot)
    trc = tlanes.RobotConsts(tfn(T=2, device="cpu").problem.state.robot)
    rng = np.random.default_rng(nl)
    q, v, a = (rng.standard_normal((9, nl)) for _ in range(3))
    b = rng.standard_normal((9, nl))

    def lanes(arr, mod):
        return [mod(arr[:, i]) for i in range(nl)]

    J, T = jnp.asarray, torch.tensor
    tau_j = jlanes.rnea_lanes(jrc, lanes(q, J), lanes(v, J), lanes(a, J))
    tau_t = tlanes.rnea_lanes(trc, lanes(q, T), lanes(v, T), lanes(a, T))
    M_j, nle_j = jlanes.mass_nle_lanes(jrc, lanes(q, J), lanes(v, J))
    M_t, nle_t = tlanes.mass_nle_lanes(trc, lanes(q, T), lanes(v, T))
    L_j, L_t = jlanes.choln(M_j), tlanes.choln(M_t)
    x_j = jlanes.choln_solve(L_j, lanes(b, J))
    x_t = tlanes.choln_solve(L_t, lanes(b, T))
    s_j, s_t = jlanes.solven(M_j, lanes(b, J)), tlanes.solven(M_t, lanes(b, T))
    for i in range(nl):
        for got, want in ((tau_t[i], tau_j[i]), (nle_t[i], nle_j[i]), (x_t[i], x_j[i]),
                          (s_t[i], s_j[i])):
            _close(got.numpy(), want, 1e-12)
        for j in range(nl):
            _close(M_t[i][j].numpy(), M_j[i][j], 1e-12)
            if j <= i:
                _close(L_t[i][j].numpy(), L_j[i][j], 1e-12)


@pytest.mark.parametrize("name", list(PRESETS))
def test_ndof_preset_models_match_jax(name):
    jfn, tfn, nl = PRESETS[name]
    jw, tw = jfn(T=4), tfn(T=4, device="cpu")
    assert tw.problem.state.nx == 4 * nl and tw.problem.nu == nl
    _close(tw.target.numpy(), jw.target, 1e-12)
    rng = np.random.default_rng(nl)
    x = 0.4 * rng.standard_normal((N, 4 * nl))
    u = 2.0 * rng.standard_normal((N, nl))
    knots = ("running", "terminal")

    def jax_all(x_, u_):        # one compiled function for every quantity
        out = {}
        for knot in knots:
            m = getattr(jw.problem, knot)
            out[knot] = m.calc_with_diff(x_, u_)
        return out, jw.problem.running.differential.quasi_static(x_)

    jout, jq = jax.jit(jax.vmap(jax_all))(x, u)
    for knot in knots:
        tm = getattr(tw.problem, knot)
        jdata, jwd = jout[knot]
        tdata, twd = tm.calc_with_diff(_t(x), _t(u))
        for field in jwd._fields:
            _close(getattr(twd, field).numpy(), getattr(jwd, field), 1e-10)
        _close(tdata.xnext.numpy(), jdata.xnext, 1e-10)
        _close(tdata.cost.numpy(), jdata.cost, 1e-10)
    _close(tw.problem.running.differential.quasi_static(_t(x)).numpy(), jq, 1e-10)


THREE_DOF = (8, 4, dict(maxiter=5, th_stop=1e-9))       # T, B, settings


@pytest.fixture(scope="module")
def jax_three_dof():
    return jax_reference("three_dof_sea", *THREE_DOF)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("route", ["lanes", True], ids=["lanes", "fast"])
def test_three_dof_solves_match_jax_generic(jax_three_dof, route, warm):
    check_solve("three_dof_sea", *THREE_DOF, warm, route, jax_three_dof)
