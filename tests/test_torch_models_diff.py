"""Derivatives of the port's ops and models against the JAX package's.

Seeded numpy inputs (float64) go through the JAX function (under
``jit(vmap)``) and the port's (batched over the leading dim): ``jlog6`` at
and near theta = 0 and pi (every branch of ``log3``, whose sanitizing must
keep the tangents finite), ``frame_jacobian_local``, ``rnea_derivatives``;
``calc_diff`` of the SEA and VSA dynamics, ``calc_diff`` and
``calc_with_diff`` of the integrator (running and terminal) and of every
cost of the presets, along a random trajectory and with a frame-placement
target a rotation of nearly pi away. Tolerance: 1e-10 relative to each
quantity's largest entry (forward-mode derivatives through the same
closed forms, summed in another order), 1e-7 for the costs with the
target near pi: there the log's Jacobian moves by 1e-8 when the frame's
rotation moves by one unit in the last place (the JAX package's own
``jlog6`` does), and the two packages' forward kinematics differ by that.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aslr_to_tpu.ops import rigid_body as jrbd
from aslr_to_tpu.ops import se3 as jse3
from aslr_to_tpu.ops import so3 as jso3
from aslr_to_tpu.workloads.presets import two_dof_sea as jax_sea
from aslr_to_tpu.workloads.presets import two_dof_vsa_boxddp as jax_vsa
from aslr_to_tpu_torch.ops import rigid_body as trbd
from aslr_to_tpu_torch.ops import se3 as tse3
from aslr_to_tpu_torch.workloads.presets import two_dof_sea, two_dof_vsa_boxddp

TOL = 1e-10
N = 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _t(a):
    return torch.tensor(np.asarray(a))


def _rot(axis, theta):
    return np.asarray(jso3.exp3(jnp.asarray(theta * np.asarray(axis) / np.linalg.norm(axis))))


def test_jlog6_matches_jax_near_zero_and_pi():
    rng = np.random.default_rng(0)
    thetas = [0.0, 1e-9, 1e-5, 0.7, 2.0, np.pi - 1e-2, np.pi - 1e-4, np.pi - 1e-6]
    rots = [_rot([0.3, -0.2, 1.0], th) for th in thetas]
    rots += [np.asarray(jso3.exp3(jnp.asarray(w))) for w in rng.standard_normal((4, 3))]
    rots = np.stack(rots)
    trans = rng.standard_normal((len(rots), 3))
    want = jax.jit(jax.vmap(lambda R, p: jse3.jlog6(jse3.SE3(R, p))))(rots, trans)
    got = tse3.jlog6(tse3.SE3(_t(rots), _t(trans)))
    _close(got.numpy(), want, tol=1e-9)


@pytest.fixture(scope="module")
def vsa():
    return jax_vsa(T=4), two_dof_vsa_boxddp(T=4, device="cpu")


@pytest.fixture(scope="module")
def sea():
    return jax_sea(T=4), two_dof_sea(T=4, device="cpu")


def _trajectory(nu, seed):
    rng = np.random.default_rng(seed)
    x = 0.4 * rng.standard_normal((N, 8))
    u = rng.standard_normal((N, nu)) * np.array([2.0, 2.0, 1.0, 1.0])[:nu]
    if nu == 4:
        u[:, 2:] = np.abs(u[:, 2:])
    return x, u


def test_frame_jacobian_and_rnea_derivatives_match_jax(vsa):
    jw, tw = vsa
    jrob, trob = jw.problem.state.robot, tw.problem.state.robot
    fid = jrob.frame_id("EE")
    rng = np.random.default_rng(1)
    q, v, a = (rng.standard_normal((N, 2)) for _ in range(3))
    want = jax.jit(jax.vmap(lambda q_: jrbd.frame_jacobian_local(jrob, q_, fid)))(q)
    _close(trbd.frame_jacobian_local(trob, _t(q), fid).numpy(), want)
    dq, dv = jax.jit(jax.vmap(lambda *z: jrbd.rnea_derivatives(jrob, *z)))(q, v, a)
    tdq, tdv = trbd.rnea_derivatives(trob, _t(q), _t(v), _t(a))
    _close(tdq.numpy(), dq)
    _close(tdv.numpy(), dv)


@pytest.mark.parametrize("arm", ["vsa", "sea"])
def test_dynamics_and_integrator_derivatives_match_jax(arm, vsa, sea):
    jw, tw = vsa if arm == "vsa" else sea
    nu = tw.problem.nu
    x, u = _trajectory(nu, seed=2)
    for knot in ("running", "terminal"):
        jm, tm = getattr(jw.problem, knot), getattr(tw.problem, knot)
        if knot == "running":
            jd = jax.jit(jax.vmap(jm.differential.calc_diff))(x, u)
            td = tm.differential.calc_diff(_t(x), _t(u))
            _close(td.Fx.numpy(), jd.Fx)
            _close(td.Fu.numpy(), jd.Fu)
            for name in jd.costs._fields:
                _close(getattr(td.costs, name).numpy(), getattr(jd.costs, name))
        ja = jax.jit(jax.vmap(jm.calc_diff))(x, u)
        (jdata, jwd) = jax.jit(jax.vmap(jm.calc_with_diff))(x, u)
        ta = tm.calc_diff(_t(x), _t(u))
        tdata, twd = tm.calc_with_diff(_t(x), _t(u))
        for name in ja._fields:
            _close(getattr(ta, name).numpy(), getattr(ja, name))
            _close(getattr(twd, name).numpy(), getattr(jwd, name))
        _close(tdata.xnext.numpy(), jdata.xnext)
        _close(tdata.cost.numpy(), jdata.cost)


@pytest.mark.parametrize("target", ["preset", "near_pi"])
def test_every_cost_derivative_matches_jax(target, vsa):
    """Each cost of the VSA preset's running sum (frame placement, state
    and control regularizers), a stiffness cost, and the sum; ``near_pi``
    moves the frame target so that the residual's rotation is pi - 1e-4."""
    jw, tw = vsa
    jdiff, tdiff = jw.problem.running.differential, tw.problem.running.differential
    x, u = _trajectory(4, seed=3)
    jsum, tsum = jdiff.costs, tdiff.costs
    if target == "near_pi":
        jrob = jw.problem.state.robot
        fid = jsum.items[0].cost.residual.frame_id
        oMf = jrbd.frame_placement(jrob, jnp.asarray(x[0, :2]), fid)
        R = np.asarray(oMf.rot) @ _rot([0.2, 1.0, -0.4], np.pi - 1e-4).T
        p = np.asarray(oMf.trans) + 0.05

        def retarget(s, mod, rot, trans):
            goal = s.items[0]
            res = dataclasses.replace(goal.cost.residual, placement=mod.SE3(rot, trans))
            item = dataclasses.replace(goal, cost=dataclasses.replace(goal.cost, residual=res))
            return dataclasses.replace(s, items=(item,) + s.items[1:])

        jsum = retarget(jsum, jse3, jnp.asarray(R), jnp.asarray(p))
        tsum = retarget(tsum, tse3, _t(R), _t(p))
    from aslr_to_tpu.models.costs import CostModelStiffness as JStiff
    from aslr_to_tpu_torch.models.costs import CostModelStiffness as TStiff
    jitems = [it.cost for it in jsum.items] + [
        JStiff(jdiff.state, 4, lamda=jnp.asarray(10.0), Kref=jnp.asarray([0.5, 0.5]))]
    titems = [it.cost for it in tsum.items] + [
        TStiff(tdiff.state, 4, lamda=torch.tensor(10.0, dtype=torch.float64),
               Kref=torch.tensor([0.5, 0.5], dtype=torch.float64))]
    tol = 1e-7 if target == "near_pi" else TOL
    for jc, tc in [(j, c) for j, c in zip(jitems, titems)] + [(jsum, tsum)]:
        def jfun(x_, u_, jc=jc):
            kin = jdiff.calc(x_, u_).kin
            return jc.calc(x_, u_, kin), jc.calc_diff(x_, u_, kin)

        jcost, jd = jax.jit(jax.vmap(jfun))(x, u)
        kin = tdiff.calc(_t(x), _t(u)).kin
        _close(tc.calc(_t(x), _t(u), kin).numpy(), jcost)
        td = tc.calc_diff(_t(x), _t(u), kin)
        for name in jd._fields:
            _close(getattr(td, name).numpy(), getattr(jd, name), tol)
        if hasattr(jc, "activation"):
            r = jc.residual.calc(jnp.asarray(x[0]), jnp.asarray(u[0]), jax.tree.map(
                lambda a: a[0], jax.vmap(jdiff.calc)(x, u).kin))
            Ar, Arr = jc.activation.calc_diff(r)
            tAr, tArr = tc.activation.calc_diff(_t(np.asarray(r)))
            _close(tAr.numpy(), Ar)
            _close(tArr.numpy(), Arr)
