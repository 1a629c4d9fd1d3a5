"""The port's standalone BoxQP (``solvers/boxqp.py``) against the JAX
package's and against scipy, as ``tests/test_boxqp.py`` does.

The same seeded random QPs (float64) go through the port batched over
their leading dim and through JAX ``vmap(boxqp)``; the solutions and free
sets agree to 1e-12 and match scipy's L-BFGS-B optimum to 1e-6. An
indefinite free block gives NaN (the regularization retry reads it), not
an exception.
"""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import minimize

from aslr_to_tpu.solvers import boxqp as jbq
from aslr_to_tpu_torch.solvers import boxqp as tbq

N_QP = 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_qps(n=4):
    """``tests/test_boxqp.py::_rand_qp`` for seeds 0..N_QP-1, stacked."""
    out = []
    for seed in range(N_QP):
        rng = np.random.RandomState(seed)
        A = rng.randn(n, n)
        out.append((A @ A.T + 0.1 * np.eye(n), rng.randn(n), -np.abs(rng.randn(n)),
                    np.abs(rng.randn(n))))
    return [np.stack(z) for z in zip(*out)]


@pytest.mark.parametrize("maxiter,warm", [(30, False), (2, True)])
def test_boxqp_matches_jax_and_scipy(maxiter, warm):
    H, q, lb, ub = _rand_qps()
    x0 = (0.3 * np.random.default_rng(0).standard_normal(q.shape) if warm
          else np.zeros_like(q))
    ref = jax.jit(jax.vmap(lambda *a: jbq.boxqp(*a, maxiter=maxiter, n_alphas=5)))(
        H, q, lb, ub, x0)
    got = tbq.boxqp(*map(torch.tensor, (H, q, lb, ub, x0)), maxiter=maxiter, n_alphas=5)
    np.testing.assert_allclose(got.x.numpy(), ref.x, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got.free.numpy(), ref.free)
    np.testing.assert_array_equal(got.converged.numpy(), ref.converged)
    if maxiter < 30:
        return
    for i in range(N_QP):
        def f(x, i=i):
            return 0.5 * x @ H[i] @ x + q[i] @ x

        sp = minimize(f, np.zeros(4), jac=lambda x, i=i: H[i] @ x + q[i],
                      bounds=list(zip(lb[i], ub[i])), method="L-BFGS-B",
                      options=dict(ftol=1e-16, gtol=1e-12))
        assert f(got.x[i].numpy()) <= sp.fun + 1e-8
        assert np.allclose(got.x[i].numpy(), sp.x, atol=1e-6)


def test_masked_free_solve_matches_jax():
    H, q, _, _ = _rand_qps()
    free = np.random.default_rng(1).random(q.shape) > 0.4
    B = np.random.default_rng(2).standard_normal((N_QP, 4, 3))
    for rhs in (q, B):
        ref = jax.jit(jax.vmap(jbq.masked_free_solve))(H, free, rhs)
        got = tbq.masked_free_solve(torch.tensor(H), torch.tensor(free), torch.tensor(rhs))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)
        assert np.all(got.numpy()[~free] == 0.0)


def test_indefinite_free_block_gives_nan_not_an_error():
    H = torch.tensor([[[1.0, 0.0], [0.0, -1.0]], [[2.0, 0.3], [0.3, 1.0]]], dtype=torch.float64)
    free = torch.ones(2, 2, dtype=torch.bool)
    x = tbq.masked_free_solve(H, free, torch.ones(2, 2, dtype=torch.float64))
    assert bool(torch.isnan(x[0]).all()) and bool(torch.isfinite(x[1]).all())
    ref = jbq.masked_free_solve(jnp.asarray(H[0].numpy()), jnp.ones(2, bool), jnp.ones(2))
    assert np.isnan(np.asarray(ref)).all()
    # clamping the negative direction leaves a definite free block
    x = tbq.masked_free_solve(H[:1], torch.tensor([[True, False]]), torch.ones(1, 2,
                                                                         dtype=torch.float64))
    assert x.tolist() == [[1.0, 0.0]]
