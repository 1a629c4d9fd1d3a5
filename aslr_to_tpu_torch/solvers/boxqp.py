"""Projected-Newton box-constrained QP, batched over leading dims.

PyTorch counterpart of ``aslr_to_tpu/solvers/boxqp.py`` (Crocoddyl's
``BoxQP``), used per knot by the generic BoxDDP/BoxFDDP backward:

    min_x 0.5 x' H x + q' x   s.t.  lb <= x <= ub

The clamped set (at a bound with the gradient pushing outward) is found,
a Newton step is taken on the free subsystem through a full-size masked
system (clamped rows and columns replaced by identity), and an Armijo
search over the step lengths keeps the first acceptable one. The
iteration count is fixed and each problem stops updating once it has
converged or rejected every step: the JAX package's masked scan.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class BoxQPResult(NamedTuple):
    x: torch.Tensor          # [..., n]
    free: torch.Tensor       # [..., n] bool
    converged: torch.Tensor  # [...] bool


def cholesky_nan(A):
    """Lower Cholesky factor of ``A [..., n, n]``, NaN where ``A`` is not
    positive definite: ``jnp.linalg.cholesky``'s answer, which the solver's
    regularization retry reads, where ``torch.linalg.cholesky`` would raise
    (and sync the host on the card)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def cho_solve(L, b):
    """Solve ``L L' x = b`` for ``b [..., n]`` or ``[..., n, m]`` (the
    number of dims tells: one less than ``L``'s is a vector)."""
    if b.dim() == L.dim() - 1:
        return torch.cholesky_solve(b[..., None], L)[..., 0]
    return torch.cholesky_solve(b, L)


def masked_free_solve(H, free, B):
    """Solve ``H_ff X_f = B_f`` through the full-size masked system; exact
    zeros on the clamped rows. ``B`` is ``[..., n]`` or ``[..., n, m]``. An
    indefinite free block gives NaN (Cholesky), which the regularization
    retry reads."""
    n = H.shape[-1]
    f = free.to(H.dtype)
    A = H * (f[..., :, None] * f[..., None, :]) + torch.eye(
        n, dtype=H.dtype, device=H.device) * (1.0 - f)[..., None, :]
    L = cholesky_nan(A)
    if B.dim() == free.dim():
        return cho_solve(L, B * f)
    return cho_solve(L, B * f[..., :, None])


def _mv(H, x):
    return (H @ x[..., None])[..., 0]


def _free(H, q, x, lb, ub):
    g = q + _mv(H, x)
    clamped = ((x <= lb) & (g >= 0.0)) | ((x >= ub) & (g <= 0.0))
    return g, ~clamped


def boxqp(H, q, lb, ub, x_init, maxiter: int = 10, th_acceptstep: float = 0.1,
          th_grad: float = 1e-9, n_alphas: int = 10) -> BoxQPResult:
    """Fixed-iteration masked projected Newton: ``H [..., n, n]``, ``q``,
    ``lb``, ``ub``, ``x_init [..., n]``."""
    alphas = torch.tensor([2.0 ** -i for i in range(n_alphas)], dtype=H.dtype,
                          device=H.device)

    def fval(x, Hb, qb):
        return 0.5 * (x * _mv(Hb, x)).sum(-1) + (qb * x).sum(-1)

    x = torch.minimum(torch.maximum(x_init, lb), ub)
    done = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    lb_a, ub_a = lb[..., None, :], ub[..., None, :]
    H_a, q_a = H[..., None, :, :], q[..., None, :]
    for _ in range(maxiter):
        g, free = _free(H, q, x, lb, ub)
        converged_now = (g * free.to(g.dtype)).abs().amax(-1) < th_grad
        dx = -masked_free_solve(H, free, g)
        # Armijo over every step length at once; the first acceptable wins
        xa = torch.minimum(torch.maximum(x[..., None, :] + alphas[:, None] * dx[..., None, :],
                                         lb_a), ub_a)                 # [..., A, n]
        accept = (fval(xa, H_a, q_a) - fval(x, H, q)[..., None]
                  <= th_acceptstep * alphas * (g * dx).sum(-1)[..., None])
        any_accept = accept.any(-1)
        idx = accept.to(torch.uint8).argmax(-1)
        x_sel = torch.take_along_dim(xa, idx[..., None, None], dim=-2)[..., 0, :]
        x_new = torch.where(any_accept[..., None], x_sel, x)
        x = torch.where(done[..., None], x, x_new)
        done = done | converged_now | ~any_accept
    g, free = _free(H, q, x, lb, ub)
    conv = (g * free.to(g.dtype)).abs().amax(-1) < 1e-6
    return BoxQPResult(x=x, free=free, converged=conv)
