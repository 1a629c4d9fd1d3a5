"""The Box Riccati backward (K2) plain version against the JAX package's
``solvers/ddp.py::_box_backward_scan`` under ``vmap``, on a real
linearization.

Cold (``qp_iters=6``, QPs from 0) and warm (``qp_iters=2`` from -kprev).
Two of the eight lanes run at a negative regularization that makes Quu
indefinite, so ``ok`` and ``retryable`` are exercised both ways. The JAX
reference factors with LAPACK and its BoxQP stops iterating once converged;
the port follows the Pallas kernel (unrolled Cholesky, fixed iterations):
tolerance 1e-9 relative to each tensor's largest entry, flags equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aslr_to_tpu.solvers.ddp import _box_backward_scan, _linearize_core
from aslr_to_tpu.workloads.presets import two_dof_vsa_boxddp as jax_preset
from aslr_to_tpu_torch.kernels import build
from aslr_to_tpu_torch.kernels.riccati import riccati_box_backward

T, B = 6, 8
RTOL = 1e-9
REG = np.array([1e-9] * 6 + [-0.05, -0.05])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def linearization():
    jw = jax_preset(T=T)
    rng = np.random.default_rng(0)
    xs = 0.3 * rng.standard_normal((B, T + 1, 8))
    us = rng.standard_normal((B, T, 4)) * np.array([3.0, 3.0, 2.0, 2.0])
    us[..., 2:] = np.abs(us[..., 2:])
    kprev = 0.5 * rng.standard_normal((B, T, 4))
    _, run, term, _ = jax.jit(jax.vmap(lambda x, u: _linearize_core(jw.problem, x, u)))(
        jnp.asarray(xs), jnp.asarray(us))
    return jw, us, kprev, run, term


def _lanes(a):
    return torch.tensor(np.moveaxis(np.asarray(a), 0, -1).copy())


def _close(got, want):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


@pytest.mark.parametrize("warm", [False, True], ids=["cold_qp6", "warm_qp2"])
def test_riccati_box_plain_matches_jax(linearization, warm):
    jw, us, kprev, run, term = linearization
    qp_iters = 2 if warm else 6
    derivs = (run.Fx, run.Fu, run.Lx, run.Lu, run.Lxx, run.Lxu, run.Luu, term.Lx, term.Lxx)
    lb, ub = jw.bounds.lb, jw.bounds.ub

    def ref_one(*a):
        *d, u, kp, reg = a
        return _box_backward_scan(*d, u, lb, ub, reg, qp_iters,
                                  kprev=kp if warm else None)

    k, K, dg, dq, stop, ok, retry = jax.jit(jax.vmap(ref_one))(
        *derivs, jnp.asarray(us), jnp.asarray(kprev), jnp.asarray(REG))

    lb_l = torch.tensor(np.asarray(lb))[:, None].expand(4, B).contiguous()
    ub_l = torch.tensor(np.asarray(ub))[:, None].expand(4, B).contiguous()
    build.reset_launches()
    out = riccati_box_backward(*map(_lanes, derivs), _lanes(us),
                               _lanes(kprev) if warm else None, lb_l, ub_l,
                               torch.tensor(REG), qp_iters)
    assert build.LAUNCHES["riccati_box"] == 0

    np.testing.assert_array_equal(out.ok.numpy(), np.asarray(ok))
    np.testing.assert_array_equal(out.retryable.numpy(), np.asarray(retry))
    assert out.ok.tolist() == [True] * 6 + [False] * 2
    good = np.asarray(ok)
    _close(np.moveaxis(out.k.numpy(), -1, 0)[good], np.asarray(k)[good])
    _close(np.moveaxis(out.K.numpy(), -1, 0)[good], np.asarray(K)[good])
    for got, want in ((out.dg, dg), (out.dq, dq), (out.stop, stop)):
        _close(got.numpy()[good], np.asarray(want)[good])
