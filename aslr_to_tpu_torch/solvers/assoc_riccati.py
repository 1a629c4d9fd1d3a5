"""Log-depth (associative-scan) Riccati backward for long horizons.

PyTorch counterpart of ``aslr_to_tpu/solvers/assoc_riccati.py``, written
batch-first: the unbounded (DDP/FDDP) backward as a reverse scan of
value-function maps over the knots, O(log T) deep instead of the
sequential sweep's O(T). Eliminating the control from one knot's KKT
conditions gives an affine two-point relation between the state and the
costate at consecutive knots::

    x_{t+1} = A x_t - B lam_{t+1} + c
    lam_t   = C x_t + A^T lam_{t+1} + d

with, per knot (``luu_r = Luu + reg*I``)::

    A = Fx - Fu luu_r^-1 Lxu^T        B = Fu luu_r^-1 Fu^T
    C = Lxx - Lxu luu_r^-1 Lxu^T + reg*I
    c = -Fu luu_r^-1 Lu + A fs_t      d = Lx - Lxu luu_r^-1 Lu + C fs_t

(the ``fs`` terms fold the FDDP gap deflection into the element; zero gaps
give plain DDP). The relations compose associatively (:func:`_combine`);
a reverse scan gives every suffix relation t -> T, closing each against
the terminal costate gives (Vx_t, Vxx_t) at every knot, and the gains and
expected-improvement terms follow from the sequential sweep's own knot
formulas (``ddp._q_terms``, ``ddp._value``), vectorized over the knots.
The outputs agree with the sequential sweep to reassociation error.

This is no kernel: batched ``torch`` products, inverses and Cholesky
factors over ``[B, T, n, n]``. The inverses and factors are the ``_ex``
forms with NaN where a factor fails (``jnp.linalg``'s answer, where
``torch.linalg`` would raise), so a failed knot gives the JAX package's
flags: ``ok`` false, and ``retryable`` where Quu was finite.

Scope: the unbounded families only. The Box variants' recursion passes
through the clamped QP, which is not a linear-fractional map of Vxx.
"""
from __future__ import annotations

import torch

from .boxqp import cho_solve, cholesky_nan
from .ddp import _mv, _q_terms, _value


def _t(A):
    return A.transpose(-1, -2)


def _inv(A):
    """``A^-1`` over the leading dims, NaN where ``A`` is singular."""
    inv, info = torch.linalg.inv_ex(A)
    return torch.where((info == 0)[..., None, None], inv, torch.nan)


def _combine(e2, e1):
    """Compose relations: ``e1`` spans [t, j), ``e2`` spans [j, k); the
    later element comes first, as ``associative_scan(reverse=True)`` passes
    them. One inverse of M = I + B1 C2 serves its three applications."""
    A1, B1, C1, c1, d1 = e1
    A2, B2, C2, c2, d2 = e2
    eye = torch.eye(A1.shape[-1], dtype=A1.dtype, device=A1.device)
    Minv = _inv(eye + B1 @ C2)
    MA1 = Minv @ A1
    Mc = _mv(Minv, c1 - _mv(B1, d2))
    MB1 = Minv @ B1
    A12 = A2 @ MA1
    B12 = B2 + A2 @ MB1 @ _t(A2)
    C12 = C1 + _t(A1) @ C2 @ MA1
    c12 = c2 + _mv(A2, Mc)
    d12 = d1 + _mv(_t(A1), _mv(C2, Mc) + d2)
    return A12, B12, C12, c12, d12


def _elements(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs_run, reg_m):
    """The knots' relation elements, ``[B, T, ...]``; ``reg_m`` broadcasts
    over a ``[B, T, n, n]`` block. One LU of ``luu_r`` a knot serves its
    three right-hand sides."""
    ndx, nu = Fx.shape[-1], Fu.shape[-1]
    eye_u = torch.eye(nu, dtype=Fx.dtype, device=Fx.device)
    eye_x = torch.eye(ndx, dtype=Fx.dtype, device=Fx.device)
    luu_r = Luu + reg_m * eye_u
    rhs = torch.cat([_t(Lxu), _t(Fu), Lu[..., None]], dim=-1)
    sol, info = torch.linalg.solve_ex(luu_r, rhs)
    sol = torch.where((info == 0)[..., None, None], sol, torch.nan)
    iLxuT, iFuT, iLu = sol[..., :ndx], sol[..., ndx:2 * ndx], sol[..., -1]
    A = Fx - Fu @ iLxuT
    B = Fu @ iFuT
    C = Lxx - Lxu @ iLxuT + reg_m * eye_x
    c = -_mv(Fu, iLu) + _mv(A, fs_run)
    d = Lx - _mv(Lxu, iLu) + _mv(C, fs_run)
    return A, B, C, c, d


def reverse_scan(combine, elems):
    """Every suffix composition of ``elems`` (tensors ``[B, n, ...]``, the
    scan over the knot axis 1): index t of the result holds ``combine`` of
    elements t, t+1, ..., n-1, each call taking the later part first. The
    scheme of the JAX package's ``associative_scan(reverse=True)``:
    neighbours combined in pairs from the end, the half-length scan
    recursed, the other half filled in from it, so 2 log2(n) combines deep
    and O(n) in all, for any n."""
    n = elems[0].shape[1]
    if n < 2:
        return elems

    def at(e, s):
        return tuple(x[:, s] for x in e)

    off = n % 2             # an odd n leaves element 0 out of the pairs
    pairs = combine(at(elems, slice(off + 1, None, 2)), at(elems, slice(off, None, 2)))
    suf = reverse_scan(combine, pairs)          # the suffixes from off, off + 2, ...
    # the suffix from j = element j, then the one from j + 1; the last is e_{n-1}
    fill = combine(at(suf, slice(1 - off, None)), at(elems, slice(1 - off, n - 1, 2)))
    fill = tuple(torch.cat([f, e], 1) for f, e in zip(fill, at(elems, slice(n - 1, None))))
    out = []
    for a, b in zip(suf, fill):
        x = a.new_empty((a.shape[0], n) + a.shape[2:])
        x[:, off::2] = a
        x[:, 1 - off::2] = b
        out.append(x)
    return tuple(out)


def fddp_backward_assoc(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx, fs, reg):
    """The unbounded backward at log depth, batch-first: ``[B, T, ...]``
    knot derivatives, the terminal ``tLx [B, ndx]``, ``tLxx [B, ndx,
    ndx]``, the gaps ``fs [B, T+1, ndx]`` (zeros for DDP) and ``reg [B]``
    (or a number). Returns the JAX package's tuple, each lane's: (k [B, T,
    nu], K [B, T, nu, ndx], w_all [B, T+1, ndx] (the deflections Vxx_t
    fs_t), dg, dq, stop, dg_gap, dq_gap, ok, retryable), all ``[B]`` past
    w_all. Long suffixes gather reassociation error faster than the
    sequential sweep: prefer f64 where the result must track it closely."""
    Bsz, T, ndx = Fx.shape[:3]
    nu = Fu.shape[-1]
    dtype, dev = Fx.dtype, Fx.device
    eye_x = torch.eye(ndx, dtype=dtype, device=dev)
    eye_u = torch.eye(nu, dtype=dtype, device=dev)
    reg = torch.as_tensor(reg, dtype=dtype, device=dev).expand(Bsz)
    reg_t = reg[:, None, None]             # over [B, n, n]
    reg_k = reg[:, None, None, None]       # over [B, T, n, n]

    J_T = tLxx + reg_t * eye_x
    eta_T = tLx + _mv(J_T, fs[:, -1])

    elems = _elements(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs[:, :-1], reg_k)
    A, B, C, c, d = reverse_scan(_combine, elems)   # index t spans [t, T)

    # close each suffix against the terminal costate lam_T = J_T x + eta_T
    J = J_T[:, None]
    Ninv = _inv(eye_x + B @ J)
    cBe = c - _mv(B, eta_T[:, None])
    JNc = _mv(J, _mv(Ninv, cBe))
    JNA = J @ (Ninv @ A)
    Vxx = C + _t(A) @ JNA
    Vx = _mv(_t(A), JNc + eta_T[:, None]) + d

    # the value at t+1 of every knot: the closures shifted, the terminal last
    Vxx_n = torch.cat([Vxx[:, 1:], J_T[:, None]], dim=1)
    Vx_n = torch.cat([Vx[:, 1:], eta_T[:, None]], dim=1)
    Qx, Qu, Qxx, Qxu, Quu = _q_terms(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, Vx_n, Vxx_n, reg_k,
                                     eye_u)
    L = cholesky_nan(Quu)
    k = cho_solve(L, Qu)
    K = cho_solve(L, _t(Qxu))
    ok = torch.isfinite(L).flatten(-2).all(-1)
    Quuk, vx, vxx = _value(Qx, Qu, Qxx, Qxu, Quu, k, K, reg_k, eye_x)
    fs_run = fs[:, :-1]
    w = _mv(vxx, fs_run)
    vx = vx + w
    out_ok = (torch.isfinite(k).all(-1) & torch.isfinite(K).flatten(-2).all(-1)
              & torch.isfinite(vx).all(-1) & torch.isfinite(vxx).flatten(-2).all(-1))
    indef = torch.isfinite(Quu).flatten(-2).all(-1) & ~out_ok

    w_T = _mv(J_T, fs[:, -1])
    w_all = torch.cat([w, w_T[:, None]], dim=1)
    dg_gap = -(vx * fs_run).sum((1, 2)) - (eta_T * fs[:, -1]).sum(-1)
    dq_gap = (fs_run * w).sum((1, 2)) + (fs[:, -1] * w_T).sum(-1)
    return (k, K, w_all, (Qu * k).sum((1, 2)), -(k * Quuk).sum((1, 2)), (Qu * Qu).sum((1, 2)),
            dg_gap, dq_gap, ok.all(1), indef.any(1))
