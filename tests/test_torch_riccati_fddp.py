"""The FDDP (K4) and BoxFDDP (K5) backward plain versions against the JAX
package's ``solvers/ddp.py::_fddp_backward_scan`` and
``_boxfddp_backward_scan`` under ``vmap``, on a real linearization with
nonzero gaps.

K4 on the SEA arm (ndx 8, nu 2) and on the VSA arm (nu 4), K5 on the VSA
arm with its box, cold (``qp_iters=6``, QPs from 0) and warm
(``qp_iters=2`` from -kprev). The gaps come from a random trajectory, so
every node deflects. Two of the eight lanes run at a negative
regularization that makes Quu indefinite, so ``ok`` and ``retryable`` are
exercised both ways. The JAX reference factors with LAPACK and its BoxQP
stops iterating once converged; the port follows the Pallas kernel
(unrolled Cholesky, fixed iterations): tolerance 1e-9 relative to each
tensor's largest entry, flags equal.
"""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aslr_to_tpu.solvers.ddp import _boxfddp_backward_scan, _fddp_backward_scan, _linearize_core
from aslr_to_tpu.workloads.presets import two_dof_sea as jax_sea
from aslr_to_tpu.workloads.presets import two_dof_vsa_boxddp as jax_vsa
from aslr_to_tpu_torch.kernels import build
from aslr_to_tpu_torch.kernels.riccati import riccati_boxfddp_backward, riccati_fddp_backward

T, B = 6, 8
RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _linearization(preset, seed):
    """(workload, us, kprev, fs, run, term, reg) on a random trajectory."""
    jw = jax_sea(T=T) if preset == "sea" else jax_vsa(T=T)
    nu = jw.problem.nu
    rng = np.random.default_rng(seed)
    xs = 0.3 * rng.standard_normal((B, T + 1, 8))
    us = rng.standard_normal((B, T, nu)) * (np.array([3.0, 3.0, 2.0, 2.0])[:nu])
    if nu == 4:
        us[..., 2:] = np.abs(us[..., 2:])
    kprev = 0.5 * rng.standard_normal((B, T, nu))
    _, run, term, xnext = jax.jit(jax.vmap(lambda x, u: _linearize_core(jw.problem, x, u)))(
        jnp.asarray(xs), jnp.asarray(us))
    x0 = xs[:, 0] + 0.01 * rng.standard_normal((B, 8))
    fs = np.concatenate([(x0 - xs[:, 0])[:, None], np.asarray(xnext) - xs[:, 1:]], axis=1)
    # the negative-reg lanes: indefinite Quu on both arms
    reg = np.array([1e-9] * 6 + [-5.0, -5.0])
    return jw, us, kprev, fs, run, term, reg


def _lanes(a):
    return torch.tensor(np.moveaxis(np.asarray(a), 0, -1).copy())


def _close(got, want):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


@pytest.mark.parametrize("family", ["fddp_sea", "fddp_vsa", "boxfddp_cold", "boxfddp_warm"])
def test_fddp_family_plain_matches_jax(family):
    preset = "sea" if family == "fddp_sea" else "vsa"
    jw, us, kprev, fs, run, term, reg = _linearization(preset, seed=3)
    derivs = (run.Fx, run.Fu, run.Lx, run.Lu, run.Lxx, run.Lxu, run.Luu, term.Lx, term.Lxx)
    boxed = family.startswith("box")
    warm = family == "boxfddp_warm"
    qp_iters = 2 if warm else 6
    nu = jw.problem.nu

    if boxed:
        lb, ub = jw.bounds.lb, jw.bounds.ub

        def ref_one(*a):
            *d, f, u, kp, r = a
            return _boxfddp_backward_scan(*d, f, u, lb, ub, r, qp_iters,
                                          kprev=kp if warm else None)

        ref = jax.jit(jax.vmap(ref_one))(*derivs, jnp.asarray(fs), jnp.asarray(us),
                                         jnp.asarray(kprev), jnp.asarray(reg))
        lb_l = torch.tensor(np.asarray(lb))[:, None].expand(nu, B).contiguous()
        ub_l = torch.tensor(np.asarray(ub))[:, None].expand(nu, B).contiguous()
        build.reset_launches()
        out = riccati_boxfddp_backward(*map(_lanes, derivs), _lanes(fs), _lanes(us),
                                       _lanes(kprev) if warm else None, lb_l, ub_l,
                                       torch.tensor(reg), qp_iters)
    else:
        ref = jax.jit(jax.vmap(_fddp_backward_scan))(*derivs, jnp.asarray(fs),
                                                     jnp.asarray(reg))
        build.reset_launches()
        out = riccati_fddp_backward(*map(_lanes, derivs), _lanes(fs), torch.tensor(reg))
    assert sum(build.LAUNCHES.values()) == 0
    k, K, w, dg, dq, stop, dg_gap, dq_gap, ok, retry = ref

    np.testing.assert_array_equal(out.ok.numpy(), np.asarray(ok))
    np.testing.assert_array_equal(out.retryable.numpy(), np.asarray(retry))
    assert out.ok.tolist() == [True] * 6 + [False] * 2
    assert out.retryable.tolist() == [False] * 6 + [True] * 2
    good = np.asarray(ok)
    assert np.abs(fs[good]).min(axis=(1, 2)).min() > 0.0          # every node has gaps
    _close(np.moveaxis(out.k.numpy(), -1, 0)[good], np.asarray(k)[good])
    _close(np.moveaxis(out.K.numpy(), -1, 0)[good], np.asarray(K)[good])
    _close(np.moveaxis(out.w.numpy(), -1, 0)[good], np.asarray(w)[good])
    for got, want in ((out.dg, dg), (out.dq, dq), (out.stop, stop),
                      (out.dg_gap, dg_gap), (out.dq_gap, dq_gap)):
        _close(got.numpy()[good], np.asarray(want)[good])
