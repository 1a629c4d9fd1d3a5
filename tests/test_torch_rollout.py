"""The two-trial rollout (K3) plain version against the JAX package's
``solvers/ddp.py::_rollout`` under ``vmap``: without gaps with clamped
controls (BoxDDP), and with the FDDP gap contraction on the SEA arm (no
box) and on the VSA arm (with the box: BoxFDDP), on lanes both feasible
and infeasible.

Large feed-forward steps push the controls against the box (the stiffness
against 0, the torques against +-100), so the clamp is exercised. The JAX
side runs the generic models (SE(3) ``log6``, dense solves), the port the
Pallas kernel's lane formulation: tolerance 1e-12 relative to each
tensor's largest entry.
"""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aslr_to_tpu.solvers.ddp import Bounds as JaxBounds
from aslr_to_tpu.solvers.ddp import _rollout
from aslr_to_tpu.workloads.presets import two_dof_sea as jax_sea
from aslr_to_tpu.workloads.presets import two_dof_vsa_boxddp as jax_preset
from aslr_to_tpu_torch import Bounds
from aslr_to_tpu_torch.kernels import build
from aslr_to_tpu_torch.kernels.vsa_kernels import extract_vsa_spec, rollout2
from aslr_to_tpu_torch.workloads.presets import two_dof_sea, two_dof_vsa_boxddp

T, B = 6, 8
RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lanes(a):
    return torch.tensor(np.moveaxis(np.asarray(a), 0, -1).copy())


def _close(got, want):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


def test_rollout2_plain_matches_jax():
    jw, tw = jax_preset(T=T), two_dof_vsa_boxddp(T=T, device="cpu")
    rng = np.random.default_rng(0)
    x0 = 0.1 * rng.standard_normal((B, 8))
    xs = 0.1 * rng.standard_normal((B, T + 1, 8))
    us = rng.standard_normal((B, T, 4)) * np.array([3.0, 3.0, 2.0, 2.0])
    us[..., 2:] = np.abs(us[..., 2:])
    # stiffness steps below the box's lower bound (0) at every knot; torque
    # steps beyond +-100 at the last knot only (earlier, such torques on the
    # 1e-3 motor inertia make the rollout chaotic within a few knots)
    k = 0.5 * rng.standard_normal((B, T, 4))
    k[..., 2:] = us[..., 2:] + 3.0 * np.abs(rng.standard_normal((B, T, 2)))
    k[:, -1, :2] = 300.0 * np.sign(rng.standard_normal((B, 2)))
    K = 0.1 * rng.standard_normal((B, T, 4, 8))
    alphas = (np.full(B, 1.0), np.full(B, 0.5) * (1 + np.arange(B) % 2))
    fs = np.zeros((T + 1, 8))

    def ref_one(x0_, xs_, us_, k_, K_, alpha):
        p = dataclasses.replace(jw.problem, x0=x0_)
        return _rollout(p, xs_, us_, k_, K_, jnp.asarray(fs), alpha, False, False, jw.bounds)

    ref = jax.jit(jax.vmap(ref_one))
    spec = extract_vsa_spec(tw.problem, tw.bounds)
    lb = torch.tensor(spec.lb)[:, None].expand(4, B).contiguous()
    ub = torch.tensor(spec.ub)[:, None].expand(4, B).contiguous()
    wterm = torch.full((B,), spec.w_goal_term, dtype=torch.float64)
    build.reset_launches()
    trials = rollout2(spec, _lanes(xs), _lanes(us), _lanes(k), _lanes(K), _lanes(x0),
                      torch.tensor(alphas[0]), torch.tensor(alphas[1]), wterm, lb, ub)
    assert build.LAUNCHES["rollout2"] == 0

    clamped = 0
    for trial, alpha in zip(trials, alphas):
        xs_j, us_j, cost_j = ref(*map(jnp.asarray, (x0, xs, us, k, K, alpha)))
        _close(np.moveaxis(trial.xs.numpy(), -1, 0), xs_j)
        _close(np.moveaxis(trial.us.numpy(), -1, 0), us_j)
        _close(trial.cost.numpy(), cost_j)
        u = np.asarray(us_j)
        clamped += int(np.sum(np.abs(u[..., :2]) == 100.0) + np.sum(u[..., 2:] == 0.0))
    assert clamped > 2 * B


@pytest.mark.parametrize("arm", ["sea", "vsa_box"])
def test_rollout2_plain_with_gaps_matches_jax(arm):
    # the VSA runs in the tight box of tests/test_lane_solver.py::_tight_bounds:
    # in the preset's wide one the stiff motor side makes the rollout chaotic
    if arm == "sea":
        jw, tw = jax_sea(T=T), two_dof_sea(T=T, device="cpu")
        scale, jb, tb = np.array([3.0, 3.0]), None, None
    else:
        jw, tw = jax_preset(T=T), two_dof_vsa_boxddp(T=T, device="cpu")
        scale = np.array([3.0, 3.0, 2.0, 2.0])
        box = (np.array([-2.0, -2.0, 0.0, 0.0]), np.array([2.0, 2.0, 3.0, 3.0]))
        jb = JaxBounds(*map(jnp.asarray, box))
        tb = Bounds(*map(torch.tensor, box))
    nu = scale.size
    rng = np.random.default_rng(1)
    x0 = 0.1 * rng.standard_normal((B, 8))
    xs = 0.1 * rng.standard_normal((B, T + 1, 8))
    us = rng.standard_normal((B, T, nu)) * scale
    if nu == 4:
        us[..., 2:] = np.abs(us[..., 2:])
    k = 0.5 * rng.standard_normal((B, T, nu))
    K = 0.1 * rng.standard_normal((B, T, nu, 8))
    fs = 0.05 * rng.standard_normal((B, T + 1, 8))
    infeas = (np.arange(B) % 3 != 0).astype(np.float64)     # lanes 0, 3, 6 feasible
    alphas = (np.full(B, 1.0), 0.5 ** (1 + np.arange(B) % 3))

    def ref_one(x0_, xs_, us_, k_, K_, fs_, alpha, on):
        p = dataclasses.replace(jw.problem, x0=x0_)
        return _rollout(p, xs_, us_, k_, K_, fs_, alpha, on, True, jb)

    ref = jax.jit(jax.vmap(ref_one))
    spec = extract_vsa_spec(tw.problem, tb)
    box = (None, None)
    if spec.lb is not None:
        box = tuple(torch.tensor(b)[:, None].expand(nu, B).contiguous()
                    for b in (spec.lb, spec.ub))
    wterm = torch.full((B,), spec.w_goal_term, dtype=torch.float64)
    build.reset_launches()
    trials = rollout2(spec, _lanes(xs), _lanes(us), _lanes(k), _lanes(K), _lanes(x0),
                      torch.tensor(alphas[0]), torch.tensor(alphas[1]), wterm, *box,
                      fs=_lanes(fs), infeas=torch.tensor(infeas))
    assert build.LAUNCHES["rollout2"] == 0

    for trial, alpha in zip(trials, alphas):
        xs_j, us_j, cost_j = ref(*map(jnp.asarray, (x0, xs, us, k, K, fs, alpha,
                                                    infeas > 0)))
        _close(np.moveaxis(trial.xs.numpy(), -1, 0), xs_j)
        _close(np.moveaxis(trial.us.numpy(), -1, 0), us_j)
        _close(trial.cost.numpy(), cost_j)
        # the gaps moved the infeasible lanes' starts, not the feasible ones'
        x_start = np.asarray(xs_j)[:, 0]
        assert np.array_equal(x_start[infeas == 0], x0[infeas == 0])
        if alpha[1] != 1.0:
            assert not np.allclose(x_start[infeas == 1], x0[infeas == 1])
