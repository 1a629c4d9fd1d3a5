"""The port's rigid-body and Lie-group ops against the JAX package's.

Inputs come from a seeded numpy generator in float64 and go to both
implementations; tolerances are 1e-12 (absolute, on quantities of order 1)
unless a comment says why not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aslr_to_tpu.models import robots as jrobots
from aslr_to_tpu.ops import lanes as jlanes
from aslr_to_tpu.ops import rigid_body as jrbd
from aslr_to_tpu.ops import se3 as jse3
from aslr_to_tpu.ops import so3 as jso3
from aslr_to_tpu_torch.models import robots as trobots
from aslr_to_tpu_torch.ops import lanes as tlanes
from aslr_to_tpu_torch.ops import rigid_body as trbd
from aslr_to_tpu_torch.ops import se3 as tse3
from aslr_to_tpu_torch.ops import so3 as tso3

TOL = 1e-12


def _jv(f):
    return jax.jit(jax.vmap(f))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _robots(name="asr_twodof"):
    """The robot ``name`` of both packages: the soft arm with the SEA
    presets' gravity along x, the double pendulum with its own."""
    if name == "double_pendulum":
        return jrobots.double_pendulum(), trobots.double_pendulum()
    g = [9.81, 0.0, 0.0]
    return jrobots.asr_twodof().with_gravity(g), trobots.asr_twodof().with_gravity(g)


def _rot_z(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _special_rotations(rng):
    """Rotations at and near theta = 0 and theta = pi (every branch of log3),
    plus random ones; about a tilted axis and about z."""
    thetas = [0.0, 1e-9, 1e-5, 1e-3, 0.7, 2.0, np.pi - 1e-2, np.pi - 1e-4,
              np.pi - 1e-7, np.pi]
    tilt = jnp.asarray(jso3.exp3(jnp.asarray([0.3, -0.2, 0.1])))
    out = [_rot_z(t) for t in thetas] + [np.asarray(tilt) @ _rot_z(t) @ np.asarray(tilt).T
                                         for t in thetas]
    xis = rng.standard_normal((6, 3))
    out += [np.asarray(jso3.exp3(jnp.asarray(w))) for w in xis]
    return np.stack(out)


def test_log3_log6_exp6_match_jax():
    rng = np.random.default_rng(0)
    R = _special_rotations(rng)
    np.testing.assert_allclose(tso3.log3(torch.tensor(R)).numpy(),
                               np.asarray(_jv(jso3.log3)(jnp.asarray(R))), atol=TOL)
    xi = rng.standard_normal((9, 6))
    Mj = _jv(jse3.exp6)(jnp.asarray(xi))
    Mt = tse3.exp6(torch.tensor(xi))
    np.testing.assert_allclose(Mt.rot.numpy(), np.asarray(Mj.rot), atol=TOL)
    np.testing.assert_allclose(Mt.trans.numpy(), np.asarray(Mj.trans), atol=TOL)
    np.testing.assert_allclose(tse3.log6(Mt).numpy(), np.asarray(_jv(jse3.log6)(Mj)),
                               atol=TOL)


def test_rnea_mass_placement_match_jax():
    _check_rnea_mass_placement("asr_twodof")


def test_rnea_mass_placement_match_jax_double_pendulum():
    _check_rnea_mass_placement("double_pendulum")


def _check_rnea_mass_placement(name):
    jr, tr = _robots(name)
    rng = np.random.default_rng(1)
    q, v, a = (rng.standard_normal((7, 2)) for _ in range(3))
    tau_j = _jv(lambda q_, v_, a_: jrbd.rnea(jr, q_, v_, a_))(q, v, a)
    np.testing.assert_allclose(trbd.rnea(tr, *map(torch.tensor, (q, v, a))).numpy(),
                               np.asarray(tau_j), atol=TOL)
    np.testing.assert_allclose(trbd.mass_matrix(tr, torch.tensor(q)).numpy(),
                               np.asarray(_jv(lambda q_: jrbd.mass_matrix(jr, q_))(q)),
                               atol=TOL)
    np.testing.assert_allclose(
        trbd.nonlinear_effects(tr, torch.tensor(q), torch.tensor(v)).numpy(),
        np.asarray(_jv(lambda q_, v_: jrbd.nonlinear_effects(jr, q_, v_))(q, v)), atol=TOL)
    pj = _jv(lambda q_: jrbd.frame_placement(jr, q_, 0))(q)
    pt = trbd.frame_placement(tr, torch.tensor(q), 0)
    np.testing.assert_allclose(pt.rot.numpy(), np.asarray(pj.rot), atol=TOL)
    np.testing.assert_allclose(pt.trans.numpy(), np.asarray(pj.trans), atol=TOL)


def _lanes(arr, mod):
    return [mod(arr[:, i]) for i in range(arr.shape[1])]


def test_lane_dynamics_twins_match_jax():
    _check_lane_dynamics_twins("asr_twodof")


def test_lane_dynamics_twins_match_jax_double_pendulum():
    _check_lane_dynamics_twins("double_pendulum")


def _check_lane_dynamics_twins(name):
    jr, tr = _robots(name)
    jrc, trc = jlanes.RobotConsts(jr), tlanes.RobotConsts(tr)
    rng = np.random.default_rng(2)
    q, v, a = (rng.standard_normal((9, 2)) for _ in range(3))
    J, T = jnp.asarray, torch.tensor
    tau_j = jlanes.rnea_lanes(jrc, _lanes(q, J), _lanes(v, J), _lanes(a, J))
    tau_t = tlanes.rnea_lanes(trc, _lanes(q, T), _lanes(v, T), _lanes(a, T))
    M_j, nle_j = jlanes.mass_nle_lanes(jrc, _lanes(q, J), _lanes(v, J))
    M_t, nle_t = tlanes.mass_nle_lanes(trc, _lanes(q, T), _lanes(v, T))
    rj, pj = jlanes.frame_placement_lanes(jrc, *jlanes.fk_lanes(jrc, _lanes(q, J)), 0)
    rt, pt = tlanes.frame_placement_lanes(trc, *tlanes.fk_lanes(trc, _lanes(q, T)), 0)
    for i in range(2):
        np.testing.assert_allclose(tau_t[i].numpy(), np.asarray(tau_j[i]), atol=TOL)
        np.testing.assert_allclose(nle_t[i].numpy(), np.asarray(nle_j[i]), atol=TOL)
        for j in range(2):
            np.testing.assert_allclose(M_t[i][j].numpy(), np.asarray(M_j[i][j]), atol=TOL)
    for i in range(3):
        np.testing.assert_allclose(pt[i].numpy(), np.asarray(pj[i]), atol=TOL)
        for j in range(3):
            np.testing.assert_allclose(rt[i][j].numpy(), np.asarray(rj[i][j]), atol=TOL)
    b = [rng.standard_normal(9) for _ in range(2)]
    xs_j = jlanes.solven(M_j, [J(x) for x in b])
    xs_t = tlanes.solven(M_t, [T(x) for x in b])
    for i in range(2):
        np.testing.assert_allclose(xs_t[i].numpy(), np.asarray(xs_j[i]), atol=TOL)


def test_log6_lanes_twin_matches_jax_near_singularities():
    """Values of every branch (theta ~ 0, generic, theta ~ pi) agree; the
    JAX twin's atan2 is a polynomial plus one Newton step (~1e-15)."""
    rng = np.random.default_rng(3)
    R = _special_rotations(rng)
    p = rng.standard_normal((R.shape[0], 3))
    rows_j = tuple(tuple(jnp.asarray(R[:, i, j]) for j in range(3)) for i in range(3))
    rows_t = tuple(tuple(torch.tensor(R[:, i, j]) for j in range(3)) for i in range(3))
    out_j = jlanes.log6_lanes(rows_j, tuple(jnp.asarray(p[:, i]) for i in range(3)))
    out_t = tlanes.log6_lanes(rows_t, tuple(torch.tensor(p[:, i]) for i in range(3)))
    for k in range(6):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), atol=TOL)


def test_dual_tangents_of_log6_match_jvp_and_stay_finite():
    """Forward-mode tangents through log6_lanes, for a rotation about z by
    an angle that crosses theta = pi: the Dual numbers of the port against
    jax.jvp of the JAX twin. Every tangent is finite, at theta = pi too
    (the double-where sanitizing must hold for the tangents). Tolerance
    1e-9: the JAX twin differentiates its polynomial atan2."""
    thetas = np.array([1e-6, 1e-3, 0.5, 2.5, np.pi - 1e-2, np.pi - 1e-5, np.pi,
                       np.pi + 1e-5, -0.3])
    p = np.random.default_rng(4).standard_normal((thetas.size, 3))

    def rows(th, mod, cos, sin):
        z = th * 0.0
        return ((cos(th), -sin(th), z), (sin(th), cos(th), z), (z, z, z + 1.0)), \
            tuple(mod(p[:, i]) for i in range(3))

    def f_j(th):
        return jlanes.log6_lanes(*rows(th, jnp.asarray, jnp.cos, jnp.sin))

    _, tan_j = jax.jvp(f_j, (jnp.asarray(thetas),), (jnp.ones(thetas.size),))
    th_t = tlanes.Dual(torch.tensor(thetas), torch.ones(thetas.size, dtype=torch.float64))
    out_t = tlanes.log6_lanes(*rows(th_t, torch.tensor, tlanes.cos, tlanes.sin))
    for k in range(6):
        tan = tlanes.tangent(out_t[k]).numpy()
        assert np.all(np.isfinite(tan))
        np.testing.assert_allclose(tan, np.asarray(tan_j[k]), atol=1e-9)


def test_dual_rnea_tangents_match_jvp():
    jr, tr = _robots()
    jrc, trc = jlanes.RobotConsts(jr), tlanes.RobotConsts(tr)
    rng = np.random.default_rng(5)
    q, v, a = (rng.standard_normal((6, 2)) for _ in range(3))
    for j in range(2):
        seed = np.zeros((6, 2))
        seed[:, j] = 1.0
        _, tj = jax.jvp(lambda qq: tuple(jlanes.rnea_lanes(
            jrc, list(qq), _lanes(v, jnp.asarray), _lanes(a, jnp.asarray))),
            (tuple(_lanes(q, jnp.asarray)),), (tuple(_lanes(seed, jnp.asarray)),))
        qd = [tlanes.Dual(torch.tensor(q[:, i]), torch.tensor(seed[:, i])) for i in range(2)]
        tt = tlanes.rnea_lanes(trc, qd, _lanes(v, torch.tensor), _lanes(a, torch.tensor))
        for i in range(2):
            np.testing.assert_allclose(tlanes.tangent(tt[i]).numpy(), np.asarray(tj[i]),
                                       atol=TOL)
