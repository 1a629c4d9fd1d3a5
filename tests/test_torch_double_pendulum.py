"""The double-pendulum swing-up and the rigid model family of the port
against the JAX package, float64 on the CPU.

Seeded numpy inputs go through the JAX function and the port's:

- ``robots.double_pendulum``: M, nle, RNEA, ``aba``, the RNEA
  derivatives, the tip's placement and LOCAL Jacobian at B=8 random (q, v,
  a, tau), to 1e-12 relative to each quantity's largest entry; the
  closed-form mass matrix and the gravity equilibria of JAX's
  ``tests/test_rigid_body.py:35, :64`` (1e-12); ``StateMultibody`` and
  ``DifferentialFreeFwdDynamics`` (``calc``, ``calc_diff``,
  ``quasi_static``) at B=8, to 1e-10 (derivatives by forward mode through
  the same RNEA, summed in another order);
- ``ActuationModelDoublePendulum`` (both ``act_link``\\ s),
  ``ResidualModelDoublePendulum``, ``ActivationModelQuadraticBarrier`` and
  the swing-up cost ``CostModelDoublePendulum``: ``calc`` and
  ``calc_diff`` at B=8, to 1e-12;
- ``presets.double_pendulum``: its leaves equal JAX's, and
  ``calc_with_diff`` of its running and terminal models along a random
  trajectory (T=10, B=8) to 1e-10; ``supports_fast_path`` refuses it with
  JAX's reason;
- the generic FDDP solve (T=10, B=8, maxiter 20, cold from the hanging x0
  plus 0.05 randn) against one JAX ``jit(vmap(solve))`` (the scan
  backward), twice: with the port's scan backward and with
  ``use_pallas_backward=True``, whose K4 runs as its plain version on the
  CPU. Iterations and flags equal, cost within rtol 1e-8;
- ``run_workload("double_pendulum", device="cpu")`` (the preset's T=10,
  maxiter 30 of its 100, to keep the file short: chip_smoke runs the whole
  budget against ``docs/northstar.json``) against JAX's ``run_workload``:
  iterations and flags equal, cost rtol 1e-8, stop rtol 1e-6, the control
  effort rtol 1e-8; the ``"auto"`` route's warning on a problem the fast
  path refuses.
"""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aslr_to_tpu as jasl
from aslr_to_tpu.models import robots as jrobots
from aslr_to_tpu.ops import rigid_body as jrbd
from aslr_to_tpu.pallas.vsa_kernels import supports_fast_path as jax_supports
from aslr_to_tpu.solvers.ddp import SolverSettings as JaxSettings
from aslr_to_tpu.solvers.ddp import solve as jax_solve
from aslr_to_tpu.workloads.presets import double_pendulum as jax_preset
from aslr_to_tpu.workloads.run import run_workload as jax_run_workload
import aslr_to_tpu_torch as tasl
from aslr_to_tpu_torch import PRESETS, SolverSettings, double_pendulum, make_batched_solver
from aslr_to_tpu_torch import run_workload
from aslr_to_tpu_torch.kernels import build
from aslr_to_tpu_torch.kernels.vsa_kernels import supports_fast_path
from aslr_to_tpu_torch.models import robots
from aslr_to_tpu_torch.ops import rigid_body as trbd
from aslr_to_tpu_torch.workloads import run as trun
from torch_lane_support import one_thread  # noqa: F401

B, T = 8, 10
X0 = np.array([3.14, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _t(a):
    return torch.tensor(np.asarray(a))


def _jv(f):
    return jax.jit(jax.vmap(f))


def test_robot_dynamics_match_jax():
    jr, tr = jrobots.double_pendulum(), robots.load("double_pendulum")
    assert tr.name == "double_pendulum" and tr.frame_id("tip") == jr.frame_id("tip") == 0
    rng = np.random.default_rng(0)
    q, v, a, tau = (rng.standard_normal((B, 2)) for _ in range(4))

    def jax_all(q_, v_, a_, tau_):
        tip = jrbd.frame_placement(jr, q_, 0)
        return (jrbd.mass_matrix(jr, q_), jrbd.nonlinear_effects(jr, q_, v_),
                jrbd.rnea(jr, q_, v_, a_), jrbd.aba(jr, q_, v_, tau_),
                jrbd.rnea_derivatives(jr, q_, v_, a_), tip.rot, tip.trans,
                jrbd.frame_jacobian_local(jr, q_, 0))

    jM, jnle, jtau, jacc, (jdq, jdv), jR, jp, jJ = _jv(jax_all)(q, v, a, tau)
    _close(trbd.mass_matrix(tr, _t(q)).numpy(), jM, 1e-12)
    _close(trbd.nonlinear_effects(tr, _t(q), _t(v)).numpy(), jnle, 1e-12)
    _close(trbd.rnea(tr, _t(q), _t(v), _t(a)).numpy(), jtau, 1e-12)
    _close(trbd.aba(tr, _t(q), _t(v), _t(tau)).numpy(), jacc, 1e-12)
    tdq, tdv = trbd.rnea_derivatives(tr, _t(q), _t(v), _t(a))
    _close(tdq.numpy(), jdq, 1e-12)
    _close(tdv.numpy(), jdv, 1e-12)
    tip = trbd.frame_placement(tr, _t(q), 0)
    _close(tip.rot.numpy(), jR, 1e-12)
    _close(tip.trans.numpy(), jp, 1e-12)
    _close(trbd.frame_jacobian_local(tr, _t(q), 0).numpy(), jJ, 1e-12)
    # aba inverts rnea
    acc = trbd.aba(tr, _t(q), _t(v), trbd.rnea(tr, _t(q), _t(v), _t(a)))
    _close(acc.numpy(), a, 1e-10)


def test_aba_of_a_singular_mass_matrix_is_nan():
    """torch.linalg raises where jnp.linalg returns NaN: aba takes the _ex
    form, so a massless chain gives NaN, not an exception."""
    tr = robots.double_pendulum()
    massless = dataclasses.replace(tr, mass=torch.zeros(2, dtype=torch.float64),
                                   inertia=torch.zeros(2, 3, 3, dtype=torch.float64))
    z = torch.zeros(3, 2, dtype=torch.float64)
    assert bool(trbd.aba(massless, z, z, z).isnan().all())


def test_mass_matrix_closed_form_and_gravity_equilibria():
    """JAX tests/test_rigid_body.py:35 and :64 on the port's robot."""
    m = robots.double_pendulum()
    q = torch.tensor([[0.3, -0.7]], dtype=torch.float64)
    M = trbd.mass_matrix(m, q)[0].numpy()
    m1 = m2 = 0.3
    l1, lc = 0.2, 0.1
    I_rod = 0.3 * 0.04 / 12
    c2 = np.cos(-0.7)
    M11 = m1 * lc ** 2 + I_rod + m2 * (l1 ** 2 + lc ** 2 + 2 * l1 * lc * c2) + I_rod
    M12 = m2 * (lc ** 2 + l1 * lc * c2) + I_rod
    M22 = m2 * lc ** 2 + I_rod
    np.testing.assert_allclose(M, [[M11, M12], [M12, M22]], atol=1e-12)
    z = torch.zeros(2, 2, dtype=torch.float64)
    up_down = torch.tensor([[0.0, 0.0], [np.pi, 0.0]], dtype=torch.float64)
    np.testing.assert_allclose(trbd.nonlinear_effects(m, up_down, z).numpy(), 0.0, atol=1e-12)


def _rigid_costs(jmod, state, nu):
    """A rigid problem's cost sum of either package: a weighted state
    regularizer and a control regularizer."""
    def arr(a):
        return jnp.asarray(a) if jmod is jasl else torch.tensor(a, dtype=torch.float64)

    xact = jmod.ActivationModelWeightedQuad(arr([1.0, 2.0, 0.5, 0.3]))
    xreg = jmod.CostModelResidual(state, xact, jmod.ResidualModelState(state, state.zero(), nu))
    ureg = jmod.CostModelResidual(state, jmod.ActivationModelQuad(),
                                  jmod.ResidualModelControl(state, nu))
    return jmod.CostModelSum(state, nu).add_cost("xReg", xreg, 1e-2).add_cost("uReg", ureg, 1e-1)


def test_state_multibody_and_free_fwd_dynamics_match_jax():
    jstate = jasl.StateMultibody(jrobots.double_pendulum())
    tstate = tasl.StateMultibody(robots.double_pendulum())
    assert (tstate.nq, tstate.nv, tstate.nx, tstate.ndx) == (2, 2, 4, 4)
    x = tstate.rand(torch.Generator().manual_seed(0))
    assert x.shape == (4,) and bool((x.abs() <= 1.0).all())
    jd = jasl.DifferentialFreeFwdDynamics(jstate, _rigid_costs(jasl, jstate, 2))
    td = tasl.DifferentialFreeFwdDynamics(tstate, _rigid_costs(tasl, tstate, 2))
    rng = np.random.default_rng(1)
    xs, us = rng.standard_normal((B, 4)), rng.standard_normal((B, 2))

    def jax_all(x, u):
        d = jd.calc(x, u)
        dd = jd.calc_diff(x, u, d)
        return d.xout, d.cost, dd.Fx, dd.Fu, dd.costs, jd.quasi_static(x)

    ja, jc, jFx, jFu, jcd, jqs = _jv(jax_all)(xs, us)
    d = td.calc(_t(xs), _t(us))
    dd = td.calc_diff(_t(xs), _t(us), d)
    _close(d.xout.numpy(), ja, 1e-12)
    _close(d.cost.numpy(), jc, 1e-12)
    _close(dd.Fx.numpy(), jFx, 1e-10)
    _close(dd.Fu.numpy(), jFu, 1e-10)
    for got, want in zip(dd.costs, jcd):
        _close(got.numpy(), want, 1e-12)
    _close(td.quasi_static(_t(xs)).numpy(), jqs, 1e-12)
    dx = np.tile(us[0], 2)
    assert np.array_equal(tstate.integrate(_t(xs[0]), _t(dx)).numpy(),
                          np.asarray(jstate.integrate(xs[0], dx)))
    assert np.array_equal(tstate.diff(_t(xs[0]), _t(xs[1])).numpy(),
                          np.asarray(jstate.diff(xs[0], xs[1])))
    for a, b in zip(tstate.jdiff(_t(xs), _t(xs)), jstate.jdiff(xs[0], xs[0])):
        assert np.array_equal(a[0].numpy(), np.asarray(b)) and a.shape == (B, 4, 4)


@pytest.mark.parametrize("act_link", [0, 1])
def test_actuation_matches_jax(act_link):
    jstate, tstate = jasl.StateASR(jrobots.double_pendulum()), tasl.StateASR(
        robots.double_pendulum())
    ja = jasl.ActuationModelDoublePendulum(jstate, act_link=act_link, nu_=2)
    ta = tasl.ActuationModelDoublePendulum(tstate, act_link=act_link, nu_=2)
    u = np.random.default_rng(2).standard_normal((B, 2))
    _close(ta.calc(None, _t(u)).numpy(), _jv(lambda u_: ja.calc(None, u_))(u), 1e-12)
    S = ta.calc_diff(None, _t(u[0]))
    assert np.array_equal(S.numpy(), np.asarray(ja.calc_diff(None, jnp.asarray(u[0]))))
    assert S.dtype == torch.float64 and S.shape == (4, 2)
    S32 = ta.calc_diff(None, torch.zeros(2, dtype=torch.float32))
    assert S32.dtype == torch.float32 and int(S32.count_nonzero()) == 1


def test_residual_barrier_and_swing_up_cost_match_jax():
    jstate, tstate = jasl.StateASR(jrobots.double_pendulum()), tasl.StateASR(
        robots.double_pendulum())
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 8)) * np.array([3, 3, 1, 1, 1, 1, 1, 1])
    u = rng.standard_normal((B, 2))
    w = [1.0, 1.0, 1.0, 1.0, 0.1, 0.1]
    jres, tres = (jasl.ResidualModelDoublePendulum(jstate, 2),
                  tasl.ResidualModelDoublePendulum(tstate, 2))
    jr, (jRx, jRu) = _jv(lambda x_: (jres.calc(x_, None, None), jres.calc_diff(x_, None, None)))(x)
    _close(tres.calc(_t(x), _t(u), None).numpy(), jr, 1e-12)
    tRx, tRu = tres.calc_diff(_t(x), _t(u), None)
    _close(tRx.numpy(), jRx, 1e-12)
    _close(tRu.numpy(), jRu, 1e-12)

    lb, ub = np.array([-0.5, -0.2, 0.0, -1.0]), np.array([0.5, 0.3, 0.1, 1.0])
    jbar = jasl.ActivationModelQuadraticBarrier(jasl.ActivationBounds(jnp.asarray(lb),
                                                                      jnp.asarray(ub)))
    tbar = tasl.ActivationModelQuadraticBarrier(tasl.ActivationBounds(_t(lb), _t(ub)))
    r = rng.standard_normal((B, 4))
    ja, (jAr, jArr) = _jv(lambda r_: (jbar.calc(r_), jbar.calc_diff(r_)))(r)
    tAr, tArr = tbar.calc_diff(_t(r))
    _close(tbar.calc(_t(r)).numpy(), ja, 1e-12)
    _close(tAr.numpy(), jAr, 1e-12)
    assert np.array_equal(tArr.numpy(), np.asarray(jArr)) and 0 < float(tArr.mean()) < 1

    jc = jasl.CostModelDoublePendulum(jstate, jasl.ActivationModelWeightedQuad(jnp.asarray(w)), 2)
    tc = tasl.CostModelDoublePendulum(tstate, tasl.ActivationModelWeightedQuad(_t(w)), 2)
    jv, jd = _jv(lambda x_, u_: (jc.calc(x_, u_, None), jc.calc_diff(x_, u_, None)))(x, u)
    _close(tc.calc(_t(x), _t(u), None).numpy(), jv, 1e-12)
    for got, want in zip(tc.calc_diff(_t(x), _t(u), None), jd):
        _close(got.numpy(), want, 1e-12)
    # the reference's diagonal Lxx at the hanging x0: (c1^2 - s1^2) + (s1^2 +
    # (1 - c1) c1) = 1 - 2 per unit weight, negative
    Lxx = tc.calc_diff(_t(X0[None]), _t(u[:1]), None).Lxx[0]
    assert float(Lxx[0, 0]) == pytest.approx(-1.0, abs=1e-5)


def _leaves(obj, out, path="p"):
    """Every tensor or array leaf of a problem, by its field path."""
    if isinstance(obj, (torch.Tensor, jnp.ndarray, np.ndarray)):
        out[path] = np.asarray(obj)
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        out[path] = np.asarray(float(obj))
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _leaves(getattr(obj, f.name), out, f"{path}.{f.name}")
    elif isinstance(obj, tuple):
        for i, c in enumerate(obj):
            _leaves(c, out, f"{path}[{i}]")
    return out


def test_preset_matches_jax():
    jw, tw = jax_preset(T=T), PRESETS["double_pendulum"](T=T, device="cpu")
    assert tw.name == jw.name == "double_pendulum"
    assert (tw.solver, tw.maxiter, tw.th_stop, tw.warm_start, tw.bounds) == (
        jw.solver, jw.maxiter, jw.th_stop, jw.warm_start, jw.bounds)
    jl, tl = _leaves(jw.problem, {}), _leaves(tw.problem, {})
    assert set(tl) == set(jl)
    for k in jl:
        assert np.array_equal(tl[k], jl[k]), k
    rng = np.random.default_rng(4)
    xs = X0 + 0.3 * rng.standard_normal((B, T, 8))
    us = rng.standard_normal((B, T, 2))
    jp, tp = jw.problem, tw.problem
    jrun = _jv(_jv(lambda x, u: jp.running.calc_with_diff(x, u)))(xs, us)
    jterm = _jv(lambda x: jp.terminal.calc_with_diff(x, jnp.zeros(2)))(xs[:, -1])
    trun_ = tp.running.calc_with_diff(_t(xs), _t(us))
    tterm = tp.terminal.calc_with_diff(_t(xs[:, -1]), torch.zeros(B, 2, dtype=torch.float64))
    for tgot, jwant in ((trun_, jrun), (tterm, jterm)):
        for group_t, group_j in zip(tgot, jwant):
            for got, want in zip(group_t, group_j):
                _close(got.numpy(), want, 1e-10)
    Fu = trun_[1].Fu
    assert bool((Fu[..., 1] == 0).all()) and bool((trun_[1].Luu[..., 1, 1] == 0).all())
    assert bool((torch.linalg.eigvalsh(tterm[1].Lxx) < 0).any(-1).all())


def test_fast_path_refuses_with_jax_reason():
    ok, reason = supports_fast_path(double_pendulum(T=T, device="cpu").problem)
    jok, jreason = jax_supports(jax_preset(T=T).problem)
    assert (ok, reason) == (jok, jreason) == (False, "SEA fast path requires ASRActuation")


@functools.lru_cache(maxsize=None)
def _x0s():
    return X0 + 0.05 * np.random.default_rng(7).standard_normal((B, 8))


@functools.lru_cache(maxsize=None)
def _jax_solve():
    """One JAX jit(vmap(solve)) reference (the scan backward), shared."""
    jp = jax_preset(T=T).problem
    s = JaxSettings(maxiter=20, th_stop=1e-9)

    def one(x0):
        p = dataclasses.replace(jp, x0=x0)
        xs0 = jnp.broadcast_to(x0, (T + 1, 8))
        return jax_solve(p, xs0, jnp.zeros((T, 2)), settings=s, use_gaps=True, bounds=None)

    return jax.jit(jax.vmap(one))(jnp.asarray(_x0s()))


@pytest.mark.parametrize("backward", ["scan", "k4_plain"])
def test_generic_solve_matches_jax(backward):
    ref = _jax_solve()
    tw = double_pendulum(T=T, device="cpu")
    s = SolverSettings(maxiter=20, th_stop=1e-9, use_pallas_backward=backward == "k4_plain")
    calls = []
    if backward == "k4_plain":
        from aslr_to_tpu_torch.kernels import riccati

        orig = riccati.riccati_batch_major

        def spy(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        mp = pytest.MonkeyPatch()
        mp.setattr(riccati, "riccati_batch_major", spy)
    build.reset_launches()
    try:
        res = make_batched_solver(tw.problem, s, use_gaps=True, bounds=None)(_t(_x0s()))
    finally:
        if backward == "k4_plain":
            mp.undo()
    assert sum(build.LAUNCHES.values()) == 0
    assert (len(calls) > 0) == (backward == "k4_plain")
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_array_equal(res.diverged.numpy(), np.asarray(ref.diverged))
    np.testing.assert_allclose(res.cost.numpy(), np.asarray(ref.cost), rtol=1e-8)
    np.testing.assert_allclose(res.stop.numpy(), np.asarray(ref.stop), rtol=1e-6)


def test_run_workload_matches_jax():
    ref = jax_run_workload("double_pendulum", JaxSettings(maxiter=30, th_stop=1e-9))
    build.reset_launches()
    got = run_workload("double_pendulum", SolverSettings(maxiter=30, th_stop=1e-9),
                       device="cpu")
    assert sum(build.LAUNCHES.values()) == 0
    r, rr = got.result, ref.result
    assert int(r.iterations) == int(rr.iterations) == 30
    assert bool(r.converged) == bool(rr.converged) and bool(r.diverged) == bool(rr.diverged)
    np.testing.assert_allclose(float(r.cost), float(rr.cost), rtol=1e-8)
    np.testing.assert_allclose(float(r.stop), float(rr.stop), rtol=1e-6)
    np.testing.assert_allclose(got.u_sq.numpy(), np.asarray(ref.u_sq), rtol=1e-8)
    assert got.ee_final.shape == (3,) and not bool(got.ee_final.any())


def test_auto_route_warns_with_the_reason(monkeypatch):
    """On a CUDA problem that supports_fast_path refuses, "auto" warns with
    the reason and takes the generic route (here a CPU problem taken for a
    card's); on a CPU problem it says nothing."""
    w = double_pendulum(T=4, device="cpu")
    s = SolverSettings(maxiter=2, th_stop=1e-9)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        quiet = trun.solve_workload(w, s)
    monkeypatch.setattr(trun, "_on_card", lambda p: True)
    with pytest.warns(UserWarning, match="SEA fast path requires ASRActuation"):
        loud = trun.solve_workload(w, s)
    assert float(loud.cost) == float(quiet.cost)
