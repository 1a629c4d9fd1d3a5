"""Backward Riccati sweeps: Box-DDP with BoxQP (K2), FDDP (K4) and BoxFDDP
(K5).

PyTorch counterpart of ``aslr_to_tpu/pallas/riccati.py``
(``_riccati_box_kernel`` through ``prepare_riccati_box_backward_lanes``;
``_riccati_fddp_kernel`` through ``prepare_riccati_fddp_backward_lanes``
and ``prepare_riccati_boxfddp_backward_lanes``). Each wrapper takes lane
tensors (batch innermost, unpadded): on a CUDA tensor it launches its
kernel (the group kernel of ``csrc/riccati_box.cu``: K2 and K5 with BoxQP
gains, without and with gaps; K4 with Cholesky gains and gaps) or raises;
on a CPU tensor it runs the plain version below, which follows the
kernel's order of operations. The plain versions are elementwise (broadcast
products and sums, no ``torch.matmul``), so no TF32 path can touch them
on the card. ``riccati_batch_major`` calls them from the per-scenario
solver's batch-major tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import build as _build
from .vsa_kernels import _check_lane, _route, from_lanes, to_lanes

QP_ALPHAS = (1.0, 0.5, 0.25, 0.125, 0.0625)


class BoxBackwardOut(NamedTuple):
    k: torch.Tensor          # [T, nu, B]
    K: torch.Tensor          # [T, nu, ndx, B]
    dg: torch.Tensor         # [B] sum Qu.k
    dq: torch.Tensor         # [B] -sum k'Quu k
    stop: torch.Tensor       # [B] sum ||Qu||^2
    ok: torch.Tensor         # [B] bool
    retryable: torch.Tensor  # [B] bool: a failure with Quu still finite


# -- plain version ------------------------------------------------------------
# Matrices are [n, m, B] tensors and vectors [n, B]. Every product is a
# sequential sum over its inner index, acc = a_0 b_0, acc = acc + a_r b_r,
# taken for a whole row or matrix at once: the kernel's order of operations
# with a few tensor ops per product.

def _matmul(A, Bm):
    """A @ B per lane: A [n,k,B], B [k,m,B] -> [n,m,B] (sum over k in order)."""
    acc = A[:, 0, None] * Bm[0, None]
    for r in range(1, A.shape[1]):
        acc = acc + A[:, r, None] * Bm[r, None]
    return acc


def _matmul_t_left(A, Bm):
    """A^T @ B per lane: A [k,n,B], B [k,m,B] -> [n,m,B]."""
    acc = A[0, :, None] * Bm[0, None]
    for r in range(1, A.shape[0]):
        acc = acc + A[r, :, None] * Bm[r, None]
    return acc


def _matvec(A, v):
    """A @ v per lane: A [n,k,B], v [...,k,B] -> [...,n,B]."""
    acc = A[:, 0] * v[..., 0, None, :]
    for r in range(1, A.shape[1]):
        acc = acc + A[:, r] * v[..., r, None, :]
    return acc


def _matvec_t(A, v):
    """A^T @ v per lane: A [k,n,B], v [k,B] -> [n,B]."""
    acc = A[0] * v[0]
    for r in range(1, A.shape[0]):
        acc = acc + A[r] * v[r]
    return acc


def _dot(a, b):
    """sum_i a_i b_i over the vector axis ([..., n, B] -> [..., B]), in order."""
    acc = a[..., 0, :] * b[..., 0, :]
    for i in range(1, a.shape[-2]):
        acc = acc + a[..., i, :] * b[..., i, :]
    return acc


def _add_diag(A, d):
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    return A + eye.reshape(eye.shape + (1,) * (A.dim() - 2)) * d


def _quad(H, q, x):
    """0.5 * sum(x * H x) + sum(q * x); x may carry a leading trial axis."""
    return 0.5 * _dot(x, _matvec(H, x)) + _dot(q, x)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _free_mask(H, q, x, low, up):
    g = q + _matvec(H, x)
    clamped = ((x <= low) & (g >= 0.0)) | ((x >= up) & (g <= 0.0))
    return g, 1.0 - clamped.to(x.dtype)


def _masked_factor(H, free):
    """Cholesky rows of the masked system (clamped rows/cols -> identity)."""
    return _chol(_add_diag(H * (free[:, None] * free[None]), 1.0 - free))


def _chol(A):
    """Unrolled Cholesky of A [n, n, B]: the rows of L as lists of lanes."""
    n = A.shape[0]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    return L


def _chol_solve(L, b):
    """Solve L L^T x = b; b [n, ..., B] (rows broadcast against L's [B])."""
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x)


def boxqp_plain(H, q, low, up, x, iters):
    """Masked projected-Newton box QP (riccati.py::_boxqp_lanes): H [n,n,B],
    q/low/up/x [n,B]; returns (x, free). The five Armijo trials are
    evaluated side by side and accepted in order."""
    x = _clip(x, low, up)
    alphas = torch.tensor(QP_ALPHAS, dtype=x.dtype, device=x.device)[:, None, None]
    for _ in range(iters):
        g, free = _free_mask(H, q, x, low, up)
        dx = -_chol_solve(_masked_factor(H, free), g * free)
        f0 = _quad(H, q, x)
        gdx = _dot(g, dx)
        xa = _clip(x + alphas * dx, low, up)                   # [5, n, B]
        fa = _quad(H, q, xa)                                    # [5, B]
        best = x
        accepted = torch.zeros_like(f0, dtype=torch.bool)
        for s, a in enumerate(QP_ALPHAS):
            ok_a = (fa[s] - f0 <= (0.1 * a) * gdx) & ~accepted
            best = torch.where(ok_a, xa[s], best)
            accepted = accepted | ok_a
        x = best
    _, free = _free_mask(H, q, x, low, up)
    return x, free


def _finite(t, nlead):
    return torch.isfinite(t).flatten(0, nlead - 1).all(0)


def _knot_box(lb, ub, t, per_knot_box):
    """Knot t's box: row t of ``[T, nu]`` tables (broadcast over the lanes),
    or the ``[nu, B]`` lanes."""
    if per_knot_box:
        return lb[t][:, None], ub[t][:, None]
    return lb, ub


def riccati_box_plain(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx, us, kprev, lb, ub, reg,
                      qp_iters, per_knot_box=False) -> BoxBackwardOut:
    """Plain PyTorch version of K2 (see :func:`riccati_box_backward`)."""
    T = Fu.shape[0]
    Vx = tLx
    Vxx = _add_diag(tLxx, reg)
    zero = torch.zeros_like(reg)
    dg, dq, stop = zero, zero, zero
    indef = torch.zeros_like(reg, dtype=torch.bool)
    ks, Ks = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        fx, fu = Fx[t], Fu[t]
        Qx = Lx[t] + _matvec_t(fx, Vx)
        Qu = Lu[t] + _matvec_t(fu, Vx)
        FxTVxx = _matmul_t_left(fx, Vxx)
        Qxu = Lxu[t] + _matmul(FxTVxx, fu)
        Quu = _add_diag(Luu[t] + _matmul(_matmul_t_left(fu, Vxx), fu), reg)
        quu_ok = _finite(Quu, 2)

        x0 = -kprev[t] if kprev is not None else torch.zeros_like(us[t])
        lo, hi = _knot_box(lb, ub, t, per_knot_box)
        du, free = boxqp_plain(Quu, Qu, lo - us[t], hi - us[t], x0, qp_iters)
        k = -du
        # free-subspace gains: columns of Qxu^T through the masked factor
        K = _chol_solve(_masked_factor(Quu, free), Qxu.transpose(0, 1) * free[:, None])

        Quuk = _matvec(Quu, k)
        Vx = Qx + _matvec_t(K, Quuk) - 2.0 * _matvec_t(K, Qu)
        V = (Lxx[t] + _matmul(FxTVxx, fx)) - _matmul(Qxu, K)
        Vxx = _add_diag(0.5 * (V + V.transpose(0, 1)), reg)
        out_ok = _finite(k, 1) & _finite(K, 2) & _finite(Vx, 1) & _finite(Vxx, 2)
        indef = indef | (quu_ok & ~out_ok)
        ks[t], Ks[t] = k, K
        dg = dg + _dot(Qu, k)
        dq = dq - _dot(k, Quuk)
        stop = stop + _dot(Qu, Qu)
    ok = torch.isfinite(dg) & torch.isfinite(dq) & torch.isfinite(stop) & _finite(Vx, 1)
    return BoxBackwardOut(k=torch.stack(ks), K=torch.stack(Ks), dg=dg, dq=dq, stop=stop,
                          ok=ok, retryable=indef)


def riccati_box_backward(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx, us,
                         kprev: Optional[torch.Tensor], lb, ub, reg,
                         qp_iters: int, per_knot_box: bool = False) -> BoxBackwardOut:
    """K2 on lane tensors: Fx [T,ndx,ndx,B], Fu [T,ndx,nu,B], Lx [T,ndx,B],
    Lu [T,nu,B], Lxx [T,ndx,ndx,B], Lxu [T,ndx,nu,B], Luu [T,nu,nu,B],
    tLx [ndx,B], tLxx [ndx,ndx,B], us [T,nu,B], kprev [T,nu,B] or None
    (cold QPs from 0), lb/ub [nu,B] (``per_knot_box``: [T,nu] tables, row
    t the box of knot t's QP), reg [B]."""
    if _route(Fx) == "plain":
        return riccati_box_plain(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx, us, kprev,
                                 lb, ub, reg, qp_iters, per_knot_box)
    out = _box_launch("riccati_box", Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx, None, us,
                      kprev, lb, ub, reg, qp_iters, per_knot_box)
    return BoxBackwardOut(k=out.k, K=out.K, dg=out.dg, dq=out.dq, stop=out.stop, ok=out.ok,
                          retryable=out.retryable)


# -- K4 / K5: the FDDP family --------------------------------------------------

class FddpBackwardOut(NamedTuple):
    k: torch.Tensor          # [T, nu, B]
    K: torch.Tensor          # [T, nu, ndx, B]
    w: torch.Tensor          # [T+1, ndx, B] deflections Vxx_t fs_t (dv = -sum w.dx)
    dg: torch.Tensor         # [B] sum Qu.k
    dq: torch.Tensor         # [B] -sum k'Quu k
    stop: torch.Tensor       # [B] sum ||Qu||^2
    dg_gap: torch.Tensor     # [B] -sum Vx.fs over the nodes (terminal included)
    dq_gap: torch.Tensor     # [B] sum fs.w
    ok: torch.Tensor         # [B] bool
    retryable: torch.Tensor  # [B] bool: a failure with Quu still finite


def _fddp_family_plain(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx, fs, reg, box):
    """Plain version of the FDDP-family sweep; ``box`` is None (K4: Cholesky
    gains) or ``(us, kprev, lb, ub, qp_iters, per_knot_box)`` (K5: masked
    BoxQP gains)."""
    T = Fu.shape[0]
    Vxx = _add_diag(tLxx, reg)
    w_T = _matvec(Vxx, fs[T])
    Vx = tLx + w_T
    dg_gap = -_dot(Vx, fs[T])
    dq_gap = _dot(fs[T], w_T)
    zero = torch.zeros_like(reg)
    dg, dq, stop = zero, zero, zero
    indef = torch.zeros_like(reg, dtype=torch.bool)
    ks, Ks, ws = [None] * T, [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        fx, fu = Fx[t], Fu[t]
        Qx = Lx[t] + _matvec_t(fx, Vx)
        Qu = Lu[t] + _matvec_t(fu, Vx)
        FxTVxx = _matmul_t_left(fx, Vxx)
        Qxu = Lxu[t] + _matmul(FxTVxx, fu)
        Quu = _add_diag(Luu[t] + _matmul(_matmul_t_left(fu, Vxx), fu), reg)
        quu_ok = _finite(Quu, 2)

        if box is None:
            L = _chol(Quu)
            k = _chol_solve(L, Qu)
            K = _chol_solve(L, Qxu.transpose(0, 1))
        else:
            us, kprev, lb, ub, qp_iters, per_knot_box = box
            x0 = -kprev[t] if kprev is not None else torch.zeros_like(us[t])
            lo, hi = _knot_box(lb, ub, t, per_knot_box)
            du, free = boxqp_plain(Quu, Qu, lo - us[t], hi - us[t], x0, qp_iters)
            k = -du
            K = _chol_solve(_masked_factor(Quu, free), Qxu.transpose(0, 1) * free[:, None])

        Quuk = _matvec(Quu, k)
        Vx = Qx + _matvec_t(K, Quuk) - 2.0 * _matvec_t(K, Qu)
        V = (Lxx[t] + _matmul(FxTVxx, fx)) - _matmul(Qxu, K)
        Vxx = _add_diag(0.5 * (V + V.transpose(0, 1)), reg)
        w = _matvec(Vxx, fs[t])
        Vx = Vx + w
        out_ok = _finite(k, 1) & _finite(K, 2) & _finite(Vx, 1) & _finite(Vxx, 2)
        indef = indef | (quu_ok & ~out_ok)
        ks[t], Ks[t], ws[t] = k, K, w
        dg = dg + _dot(Qu, k)
        dq = dq - _dot(k, Quuk)
        stop = stop + _dot(Qu, Qu)
        dg_gap = dg_gap - _dot(Vx, fs[t])
        dq_gap = dq_gap + _dot(fs[t], w)
    ok = torch.isfinite(dg) & torch.isfinite(stop) & _finite(Vx, 1)
    return FddpBackwardOut(k=torch.stack(ks), K=torch.stack(Ks),
                           w=torch.stack(ws + [w_T]), dg=dg, dq=dq, stop=stop,
                           dg_gap=dg_gap, dq_gap=dq_gap, ok=ok, retryable=indef)


def riccati_fddp_plain(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx, fs, reg) -> FddpBackwardOut:
    """Plain PyTorch version of K4 (see :func:`riccati_fddp_backward`)."""
    return _fddp_family_plain(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx, fs, reg, None)


def riccati_boxfddp_plain(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx, fs, us, kprev, lb, ub,
                          reg, qp_iters, per_knot_box=False) -> FddpBackwardOut:
    """Plain PyTorch version of K5 (see :func:`riccati_boxfddp_backward`)."""
    return _fddp_family_plain(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx, fs, reg,
                              (us, kprev, lb, ub, qp_iters, per_knot_box))


def _check_lanes(**lanes):
    """Check each lane tensor (None skipped) against its shape, which
    follows from Fu [T, ndx, nu, B], and against Fx's dtype and device."""
    T, X, U, B = lanes["Fu"].shape
    shapes = dict(Fx=(T, X, X, B), Fu=(T, X, U, B), Lx=(T, X, B), Lu=(T, U, B),
                  Lxx=(T, X, X, B), Lxu=(T, X, U, B), Luu=(T, U, U, B), tLx=(X, B),
                  tLxx=(X, X, B), fs=(T + 1, X, B), us=(T, U, B), kprev=(T, U, B), lb=(U, B),
                  ub=(U, B), lb_table=(T, U), ub_table=(T, U), reg=(B,))
    dt, dev = lanes["Fx"].dtype, lanes["Fx"].device
    for name, t in lanes.items():
        if t is not None:
            _check_lane(name, t, shapes[name], dt, dev)


def _empty_out(T, NDX, NU, B, dt, dev, gaps=True):
    """The kernel's outputs, uninitialized; without gaps (K2) no w, dg_gap
    or dq_gap."""
    def e(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device=dev)

    w, dgg, dqg = (e(T + 1, NDX, B), e(B), e(B)) if gaps else (None, None, None)
    return FddpBackwardOut(k=e(T, NU, B), K=e(T, NU, NDX, B), w=w, dg=e(B), dq=e(B),
                           stop=e(B), dg_gap=dgg, dq_gap=dqg, ok=e(B, dtype=torch.bool),
                           retryable=e(B, dtype=torch.bool))


def _box_launch(name, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx, fs, us, kprev, lb, ub, reg,
                qp_iters, per_knot_box) -> FddpBackwardOut:
    """K2 (``fs`` None) or K5: the one box kernel of ``csrc/riccati_box.cu``,
    with a box a lane or (``per_knot_box``) the ``[T, nu]`` tables, the
    latter at ndx 8 only. K2 leaves ``w``, ``dg_gap`` and ``dq_gap``
    unwritten."""
    lanes_box, tables = ((None, None), (lb, ub)) if per_knot_box else ((lb, ub), (None, None))
    _check_lanes(Fx=Fx, Fu=Fu, Lx=Lx, Lu=Lu, Lxx=Lxx, Lxu=Lxu, Luu=Luu, tLx=tLx, tLxx=tLxx,
                 fs=fs, us=us, kprev=kprev, lb=lanes_box[0], ub=lanes_box[1],
                 lb_table=tables[0], ub_table=tables[1], reg=reg)
    T, NDX, NU, B = Fu.shape
    instance = f"ndx={NDX} nu={NU}{' box tables' if per_knot_box else ''}"
    _build.require(name, instance)
    dt = Fx.dtype
    out = _empty_out(T, NDX, NU, B, dt, Fx.device, gaps=fs is not None)
    p = _build.ptr

    def opt(t):
        return None if t is None else p(t)

    code = _build.entry("aslr_riccati_box", dt)(
        NDX, NU, int(fs is not None), p(Fx), p(Fu), p(Lx), p(Lu), p(Lxx), p(Lxu), p(Luu),
        p(tLx), p(tLxx), opt(fs), p(us), opt(kprev), *map(opt, lanes_box + tables), p(reg), T,
        B, qp_iters,
        *(opt(v) for v in out), _build.stream_of(Fx))
    _build.check(name, code, instance)
    return out


def riccati_fddp_backward(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx, fs,
                          reg) -> FddpBackwardOut:
    """K4 on lane tensors: the derivatives as for
    :func:`riccati_box_backward`, the gaps fs [T+1,ndx,B] (zeros for DDP)
    and reg [B]."""
    if _route(Fx) == "plain":
        return riccati_fddp_plain(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx, fs, reg)
    _check_lanes(Fx=Fx, Fu=Fu, Lx=Lx, Lu=Lu, Lxx=Lxx, Lxu=Lxu, Luu=Luu, tLx=tLx, tLxx=tLxx,
                 fs=fs, reg=reg)
    T, NDX, NU, B = Fu.shape
    _build.require("riccati_fddp", f"ndx={NDX} nu={NU}")
    dt = Fx.dtype
    out = _empty_out(T, NDX, NU, B, dt, Fx.device)
    p = _build.ptr
    code = _build.entry("aslr_riccati_fddp", dt)(
        NDX, NU, p(Fx), p(Fu), p(Lx), p(Lu), p(Lxx), p(Lxu), p(Luu), p(tLx), p(tLxx), p(fs),
        p(reg), T, B, *(p(v) for v in out), _build.stream_of(Fx))
    _build.check("riccati_fddp", code, f"ndx={NDX} nu={NU}")
    return out


def riccati_boxfddp_backward(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx, fs, us,
                             kprev: Optional[torch.Tensor], lb, ub, reg,
                             qp_iters: int, per_knot_box: bool = False) -> FddpBackwardOut:
    """K5 on lane tensors: K4's inputs plus us [T,nu,B], kprev [T,nu,B] or
    None (cold QPs from 0), lb/ub [nu,B] (``per_knot_box``: [T,nu] tables)
    and the QP iteration count."""
    if _route(Fx) == "plain":
        return riccati_boxfddp_plain(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx, fs, us, kprev,
                                     lb, ub, reg, qp_iters, per_knot_box)
    return _box_launch("riccati_boxfddp", Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx, fs, us,
                       kprev, lb, ub, reg, qp_iters, per_knot_box)


def riccati_batch_major(run, term, fs, us, kprev, bounds, reg, qp_iters, plain=False):
    """The family's kernel from batch-major tensors, as the JAX package's
    ``custom_vmap`` rules call it under ``vmap(solve)``: ``run`` and
    ``term`` ActionDerivs ``[B, T, ...]`` and ``[B, ...]``, ``fs [B, T+1,
    ndx]`` or None (no gaps), ``us``/``kprev [B, T, nu]`` (kprev None: cold
    QPs), ``bounds`` with a shared ``[nu]`` box or None, ``reg [B]``. K2
    for a box without gaps, K5 for a box with gaps, K4 for gaps without a
    box (``plain``: their plain versions). Every tensor is relayouted to
    the lane layout and the outputs back; returns the kernel's output
    tuple with batch-major tensors."""
    derivs = [to_lanes(getattr(run, n)) for n in ("Fx", "Fu", "Lx", "Lu", "Lxx", "Lxu", "Luu")]
    derivs += [to_lanes(term.Lx), to_lanes(term.Lxx)]
    reg = reg.contiguous()
    if bounds is None:
        if fs is None:
            raise ValueError("the DDP family without box or gaps has no backward kernel")
        fn = riccati_fddp_plain if plain else riccati_fddp_backward
        out = fn(*derivs, to_lanes(fs), reg)
    else:
        B, nu = us.shape[0], us.shape[-1]
        lb, ub = (b[:, None].expand(nu, B).contiguous() for b in (bounds.lb, bounds.ub))
        kp = None if kprev is None else to_lanes(kprev)
        if fs is None:
            fn = riccati_box_plain if plain else riccati_box_backward
            out = fn(*derivs, to_lanes(us), kp, lb, ub, reg, qp_iters)
        else:
            fn = riccati_boxfddp_plain if plain else riccati_boxfddp_backward
            out = fn(*derivs, to_lanes(fs), to_lanes(us), kp, lb, ub, reg, qp_iters)
    return type(out)(*(from_lanes(v) if v.dim() > 1 else v for v in out))
