"""The linearization (K1) plain version against the JAX package's
``solvers/ddp.py::_linearize_core`` under ``vmap``, on the VSA arm and on
the SEA arm (constant spring, nu = 2).

The JAX side is ``calc_with_diff`` of the generic models (RNEA partials by
``jacfwd``, ``jlog6`` by ``jacfwd`` of ``log6``, explicit inverses); the
port follows the Pallas kernel's route (dual-number seeds, closed-form
2x2 inverse). The two agree to rounding: tolerance 1e-10 relative to
each tensor's largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aslr_to_tpu.solvers.ddp import _linearize_core
from aslr_to_tpu.workloads.presets import two_dof_sea as jax_sea
from aslr_to_tpu.workloads.presets import two_dof_vsa_boxddp as jax_preset
from aslr_to_tpu_torch.kernels import build
from aslr_to_tpu_torch.kernels.vsa_kernels import extract_vsa_spec, linearize
from aslr_to_tpu_torch.workloads.presets import two_dof_sea, two_dof_vsa_boxddp

T, B = 6, 8
RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lanes(a):
    """[B, d...] numpy -> lane tensor [d..., B]."""
    return torch.tensor(np.moveaxis(a, 0, -1).copy())


def _batch(t):
    """lane tensor [d..., B] -> [B, d...] numpy."""
    return np.moveaxis(t.numpy(), -1, 0)


def _close(got, want):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


def _trajectory(seed):
    rng = np.random.default_rng(seed)
    xs = 0.3 * rng.standard_normal((B, T + 1, 8))
    us = rng.standard_normal((B, T, 4)) * np.array([3.0, 3.0, 2.0, 2.0])
    us[..., 2:] = np.abs(us[..., 2:])
    return xs, us


def test_linearize_plain_matches_jax():
    jw, tw = jax_preset(T=T), two_dof_vsa_boxddp(T=T, device="cpu")
    xs, us = _trajectory(0)
    cost, run, term, xnext = jax.jit(jax.vmap(
        lambda x, u: _linearize_core(jw.problem, x, u)))(jnp.asarray(xs), jnp.asarray(us))

    spec = extract_vsa_spec(tw.problem, tw.bounds)
    wterm = torch.full((B,), spec.w_goal_term, dtype=torch.float64)
    build.reset_launches()
    lin = linearize(spec, _lanes(xs), _lanes(us), wterm)
    assert build.LAUNCHES["linearize"] == 0          # CPU tensors take the plain version

    _close(lin.cost.numpy(), cost)
    _close(_batch(lin.xnext), xnext)
    for name in ("Fx", "Fu", "Lx", "Lu", "Lxx", "Lxu", "Luu"):
        _close(_batch(lin.run[name]), getattr(run, name))
    _close(_batch(lin.term["Lx"]), term.Lx)
    _close(_batch(lin.term["Lxx"]), term.Lxx)
    assert bool(lin.ok.all())


def test_linearize_plain_matches_jax_sea():
    jw, tw = jax_sea(T=T), two_dof_sea(T=T, device="cpu")
    rng = np.random.default_rng(2)
    xs = 0.3 * rng.standard_normal((B, T + 1, 8))
    us = 3.0 * rng.standard_normal((B, T, 2))
    cost, run, term, xnext = jax.jit(jax.vmap(
        lambda x, u: _linearize_core(jw.problem, x, u)))(jnp.asarray(xs), jnp.asarray(us))

    spec = extract_vsa_spec(tw.problem, tw.bounds)
    assert (spec.variant, spec.nu) == ("sea", 2)
    wterm = torch.full((B,), spec.w_goal_term, dtype=torch.float64)
    build.reset_launches()
    lin = linearize(spec, _lanes(xs), _lanes(us), wterm)
    assert build.LAUNCHES["linearize"] == 0

    _close(lin.cost.numpy(), cost)
    _close(_batch(lin.xnext), xnext)
    for name in ("Fx", "Fu", "Lx", "Lu", "Lxx", "Lxu", "Luu"):
        _close(_batch(lin.run[name]), getattr(run, name))
    _close(_batch(lin.term["Lx"]), term.Lx)
    _close(_batch(lin.term["Lxx"]), term.Lxx)
    assert bool(lin.ok.all())


def test_linearize_flags_non_finite_lanes():
    """A lane whose state overflows is flagged not-ok; the others stay ok,
    and their values are unaffected by the bad lane."""
    _, tw = jax_preset(T=T), two_dof_vsa_boxddp(T=T, device="cpu")
    xs, us = _trajectory(1)
    xs_bad = xs.copy()
    xs_bad[3, 2, 4] = np.inf
    spec = extract_vsa_spec(tw.problem, tw.bounds)
    wterm = torch.full((B,), spec.w_goal_term, dtype=torch.float64)
    good = linearize(spec, _lanes(xs), _lanes(us), wterm)
    bad = linearize(spec, _lanes(xs_bad), _lanes(us), wterm)
    assert bad.ok.tolist() == [i != 3 for i in range(B)]
    keep = [i for i in range(B) if i != 3]
    np.testing.assert_array_equal(bad.run["Fx"].numpy()[..., keep],
                                  good.run["Fx"].numpy()[..., keep])
