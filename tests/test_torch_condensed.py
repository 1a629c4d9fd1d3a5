"""The condensed soft-dynamics formulation of the port
(``models/condensed.py``) against the JAX package's, float64 on the CPU.

Every quantity that JAX's ``tests/test_condensed.py`` probes, on seeded
numpy inputs through both packages and against the port's
``utils/numdiff.py`` (central differences, eps 1e-6):

- the condensed SEA on the rigid ``asr_twodof`` state (K = 3 I, B = 1e-4 I,
  nu 4: the feasibility residual weighted 4, a control regularizer 1e-2):
  the cost sum's Lx, Lu, Lxx, Lxu, Luu equal JAX's to 1e-12, and Lx, Lu
  equal the numdiff gradient of the condensed model's cost to 1e-6; the
  condensed actuation's ``calc`` and ``calc_diff`` to 1e-12;
- ``VSADynamicsResidualModel`` (nu 6): r, Rx and Ru equal JAX's to 1e-12,
  Rx and Ru numdiff to 1e-8, and r its closed form;
- the deflection barrier at +-pi K (``ActivationModelQuadraticBarrier``):
  the cost equals JAX's, below 1e-10 inside the bounds and above 1 outside;
- ``QbActuationModel``: tau, K, dtau_dx, dtau_du, dK_dx and dK_du equal
  JAX's to 1e-12, the first three numdiff to 1e-8, and dK_du is zero;
- ``SoftDynamicsResidualModel``'s Rx and Ru numdiff to 1e-8, batched calls
  equal to the per-row ones;
- ``utils/numdiff.py::assert_numdiff`` with the reference's tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aslr_to_tpu as jasl
from aslr_to_tpu.models import condensed as jcond
from aslr_to_tpu.models import robots as jrobots
import aslr_to_tpu_torch as tasl
from aslr_to_tpu_torch.models import condensed as tcond
from aslr_to_tpu_torch.models import robots
from aslr_to_tpu_torch.models.costs import KinData
from aslr_to_tpu_torch.ops import rigid_body as trbd
from aslr_to_tpu_torch.utils.numdiff import NUMDIFF_MODIFIER, assert_numdiff, numdiff
from torch_lane_support import one_thread  # noqa: F401


def _t(a):
    return torch.tensor(np.asarray(a))


def _eq(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _costs(mod, state, res, nu):
    feas = mod.CostModelResidual(state, mod.ActivationModelQuad(), res)
    ureg = mod.CostModelResidual(state, mod.ActivationModelQuad(),
                                 mod.ResidualModelControl(state, nu))
    return mod.CostModelSum(state, nu).add_cost("feas", feas, float(nu)).add_cost(
        "uReg", ureg, 1e-2)


def _condensed_cost(state, act, costs, x, u):
    """The condensed model's cost: the link torque through the actuation,
    the rigid forward dynamics (aba), the cost sum at the shared
    kinematics (as JAX's test assembles its model)."""
    q, v = state.split(x)
    trbd.aba(state.robot, q, v, act.calc(x, u))
    rots, trans = trbd.forward_kinematics(state.robot, q)
    return costs.calc(x, u, KinData(rots=rots, trans=trans))


def test_softdyn_condensed_derivatives():
    rng = np.random.default_rng(0)
    x, u = rng.uniform(-1, 1, 4), rng.uniform(0, 1, 4)
    K, Bm = 3.0 * np.eye(2), 1e-4 * np.eye(2)
    jstate = jasl.StateMultibody(jrobots.load("asr_twodof"))
    tstate = tasl.StateMultibody(robots.load("asr_twodof"))
    jres = jcond.SoftDynamicsResidualModel(jstate, 4, K=jnp.asarray(K), B=jnp.asarray(Bm))
    tres = tcond.SoftDynamicsResidualModel(tstate, 4, K=_t(K), B=_t(Bm))
    jcosts, tcosts = _costs(jasl, jstate, jres, 4), _costs(tasl, tstate, tres, 4)
    jact, tact = jcond.ASRActuationCondensed(jstate, 4, jnp.asarray(Bm)), \
        tcond.ASRActuationCondensed(tstate, 4, _t(Bm))
    _eq(tact.calc(_t(x), _t(u)).numpy(), jact.calc(jnp.asarray(x), jnp.asarray(u)))
    _eq(tact.calc_diff(_t(x), _t(u)).numpy(), jact.calc_diff(jnp.asarray(x), jnp.asarray(u)))

    jcd = jcosts.calc_diff(jnp.asarray(x), jnp.asarray(u), None)
    tcd = tcosts.calc_diff(_t(x), _t(u), None)
    for got, want in zip(tcd, jcd):
        _eq(got.numpy(), want)
    Lx_nd = numdiff(lambda x_: _condensed_cost(tstate, tact, tcosts, x_, _t(u)), x)
    Lu_nd = numdiff(lambda u_: _condensed_cost(tstate, tact, tcosts, _t(x), u_), u)
    _eq(tcd.Lx.numpy(), Lx_nd.numpy(), 1e-6)
    _eq(tcd.Lu.numpy(), Lu_nd.numpy(), 1e-6)
    assert_numdiff(tcd.Lx, Lx_nd)
    # the JAX test's own oracle: autodiff of its cost, here on the same inputs
    Lx_ad = jax.grad(lambda x_: jcosts.calc(x_, jnp.asarray(u), None))(jnp.asarray(x))
    _eq(tcd.Lx.numpy(), Lx_ad, 1e-10)


def test_softdyn_residual_batches_and_numdiff():
    rng = np.random.default_rng(1)
    xs, us = rng.uniform(-1, 1, (5, 4)), rng.uniform(-1, 1, (5, 4))
    tstate = tasl.StateMultibody(robots.load("asr_twodof"))
    tres = tcond.SoftDynamicsResidualModel(tstate, 4, K=_t(3.0 * np.eye(2)))
    r = tres.calc(_t(xs), _t(us), None)
    Rx, Ru = tres.calc_diff(_t(xs), _t(us), None)
    for i in range(5):
        _eq(r[i].numpy(), tres.calc(_t(xs[i]), _t(us[i]), None).numpy(), 0.0)
        _eq(Rx[i].numpy(), numdiff(lambda x_: tres.calc(x_, _t(us[i]), None), xs[i]).numpy(),
            1e-8)
        _eq(Ru[i].numpy(), numdiff(lambda u_: tres.calc(_t(xs[i]), u_, None), us[i]).numpy(),
            1e-8)


def test_vsa_condensed_residual_derivatives():
    rng = np.random.default_rng(2)
    x, u = rng.uniform(-1, 1, 4), rng.uniform(0, 1, 6) + 0.1
    jstate = jasl.StateMultibody(jrobots.load("asr_twodof"))
    tstate = tasl.StateMultibody(robots.load("asr_twodof"))
    jres, tres = jcond.VSADynamicsResidualModel(jstate, 6), tcond.VSADynamicsResidualModel(
        tstate, 6)
    r = tres.calc(_t(x), _t(u), None)
    Rx, Ru = tres.calc_diff(_t(x), _t(u), None)
    jRx, jRu = jres.calc_diff(jnp.asarray(x), jnp.asarray(u), None)
    _eq(r.numpy(), jres.calc(jnp.asarray(x), jnp.asarray(u), None))
    _eq(Rx.numpy(), jRx)
    _eq(Ru.numpy(), jRu)
    _eq(Rx.numpy(), numdiff(lambda x_: tres.calc(x_, _t(u), None), x).numpy(), 1e-8)
    _eq(Ru.numpy(), numdiff(lambda u_: tres.calc(_t(x), u_, None), u).numpy(), 1e-8)
    nv = 2
    _eq(r.numpy(), u[:nv] - u[2 * nv:] * (u[nv:2 * nv] - x[:nv]))


def test_softdyn_residual_with_barrier():
    """The deflection barrier at +-pi K (reference
    unittest/test_softdyn_residual.py:24-27)."""
    jstate = jasl.StateMultibody(jrobots.load("asr_twodof"))
    tstate = tasl.StateMultibody(robots.load("asr_twodof"))
    K = 3.0 * np.eye(2)
    lb, ub = -3.14 * 3.0 * np.ones(2), 3.14 * 3.0 * np.ones(2)
    jcost = jasl.CostModelResidual(
        jstate, jasl.ActivationModelQuadraticBarrier(jasl.ActivationBounds(jnp.asarray(lb),
                                                                           jnp.asarray(ub))),
        jcond.SoftDynamicsResidualModel(jstate, 4, K=jnp.asarray(K), B=1e-4 * jnp.eye(2)))
    tcost = tasl.CostModelResidual(
        tstate, tasl.ActivationModelQuadraticBarrier(tasl.ActivationBounds(_t(lb), _t(ub))),
        tcond.SoftDynamicsResidualModel(tstate, 4, K=_t(K), B=_t(1e-4 * np.eye(2))))
    x = tstate.zero()
    for u, inside in (([1.0, -1.0, 0.3, 0.2], True), ([50.0, 0.0, 0.0, 0.0], False)):
        c = float(tcost.calc(x, _t(u), None))
        assert c == pytest.approx(float(jcost.calc(jnp.zeros(4), jnp.asarray(u), None)),
                                  rel=1e-12, abs=1e-15)
        assert (c < 1e-10) if inside else (c > 1.0)


def test_qb_actuation_probed_derivatives():
    """The reference's hand-rolled check of dtau_dx, dtau_du and dK_dx
    (unittest/actuation_test.py:44-69)."""
    rng = np.random.default_rng(4)
    x, u = rng.uniform(-1, 1, 8), rng.uniform(0, 1, 2)
    jact = jcond.QbActuationModel(jasl.StateASR(jrobots.load("asr_twodof")))
    tact = tcond.QbActuationModel(tasl.StateASR(robots.load("asr_twodof")))
    d = tact.calc(_t(x), _t(u))
    jd = jact.calc(jnp.asarray(x), jnp.asarray(u))
    for got, want in zip(d, jd):
        _eq(got.numpy(), want)
    _eq(d.dtau_dx.numpy(), numdiff(lambda x_: tact.calc(x_, _t(u)).tau, x).numpy(), 1e-8)
    _eq(d.dtau_du.numpy(), numdiff(lambda u_: tact.calc(_t(x), u_).tau, u).numpy(), 1e-8)
    _eq(d.dK_dx.numpy(), numdiff(lambda x_: tact.calc(x_, _t(u)).K, x).numpy(), 1e-8)
    assert not bool(d.dK_du.any())
    assert tact.calc_diff(_t(x), _t(u)).dtau_dx.shape == (4, 8)


def test_assert_numdiff_tolerance():
    assert NUMDIFF_MODIFIER * 1e-6 == pytest.approx(0.03)
    assert_numdiff(torch.ones(3), torch.ones(3) + 0.02)
    with pytest.raises(AssertionError, match="numdiff mismatch"):
        assert_numdiff(torch.ones(3), torch.ones(3) + 0.05, msg="probe")
