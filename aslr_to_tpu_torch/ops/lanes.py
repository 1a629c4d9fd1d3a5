"""Lane-layout rigid-body dynamics: scalar graphs over batch tensors.

PyTorch twin of ``aslr_to_tpu/ops/lanes.py`` and the plain version of the
device library ``aslr_to_tpu_torch/csrc/lanes.cuh``. Joint angles and
torques are lists of tensors of one batch shape; 3-vectors and 3x3
matrices stack their entries in front of it. Every element goes through
the same sequence of operations the CUDA device functions follow per
thread. The functions also take :class:`Dual` numbers (value and tangent tensors),
which give the plain linearization its RNEA and ``log6`` partials by
forward mode, with the jvp rules of JAX that the kernel's ``Dual<T>``
follows as well.

Robot parameters enter as Python floats from a :class:`RobotConsts` snapshot.
"""
from __future__ import annotations

import math

import numpy as np
import torch


# -- forward-mode dual numbers -----------------------------------------------

class Dual:
    """Value ``v`` and tangent ``d`` (tensors of one shape). Arithmetic with
    tensors and Python numbers treats those as constants (zero tangent).
    Comparisons see the values only."""

    __slots__ = ("v", "d")

    def __init__(self, v, d):
        self.v, self.d = v, d

    def __add__(a, b):
        if isinstance(b, Dual):
            return Dual(a.v + b.v, a.d + b.d)
        return Dual(a.v + b, a.d)

    def __radd__(a, b):
        return Dual(b + a.v, a.d)

    def __sub__(a, b):
        if isinstance(b, Dual):
            return Dual(a.v - b.v, a.d - b.d)
        return Dual(a.v - b, a.d)

    def __rsub__(a, b):
        return Dual(b - a.v, -a.d)

    def __mul__(a, b):
        if isinstance(b, Dual):
            return Dual(a.v * b.v, a.d * b.v + a.v * b.d)
        return Dual(a.v * b, a.d * b)

    def __rmul__(a, b):
        return Dual(b * a.v, b * a.d)

    def __truediv__(a, b):
        if isinstance(b, Dual):
            return Dual(a.v / b.v, a.d / b.v - b.d * a.v / (b.v * b.v))
        return Dual(a.v / b, a.d / b)

    def __rtruediv__(a, b):
        return Dual(b / a.v, -a.d * b / (a.v * a.v))

    def __neg__(a):
        return Dual(-a.v, -a.d)

    def __getitem__(a, idx):
        return Dual(a.v[idx], a.d[idx])

    def __lt__(a, b):
        return a.v < val(b)

    def __le__(a, b):
        return a.v <= val(b)

    def __gt__(a, b):
        return a.v > val(b)

    def __ge__(a, b):
        return a.v >= val(b)


def val(x):
    return x.v if isinstance(x, Dual) else x


def tangent(x):
    return x.d if isinstance(x, Dual) else torch.zeros_like(x)


def sin(x):
    return Dual(torch.sin(x.v), x.d * torch.cos(x.v)) if isinstance(x, Dual) else torch.sin(x)


def cos(x):
    return Dual(torch.cos(x.v), x.d * -torch.sin(x.v)) if isinstance(x, Dual) else torch.cos(x)


def sqrt(x):
    if isinstance(x, Dual):
        r = torch.sqrt(x.v)
        return Dual(r, x.d * (0.5 / r))
    return torch.sqrt(x)


def atan2(y, x):
    if isinstance(y, Dual) or isinstance(x, Dual):
        yv, xv = val(y), val(x)
        den = xv * xv + yv * yv
        return Dual(torch.atan2(yv, xv), _d(y, yv) * (xv / den) + _d(x, xv) * (-yv / den))
    return torch.atan2(y, x)


def absolute(x):
    return Dual(torch.abs(x.v), x.d * torch.sign(x.v)) if isinstance(x, Dual) else torch.abs(x)


def _d(x, like):
    return x.d if isinstance(x, Dual) else torch.zeros_like(like)


def where(c, a, b):
    """``torch.where`` that carries tangents (a number is a constant)."""
    if isinstance(a, Dual) or isinstance(b, Dual):
        av, bv = val(a), val(b)
        vv = torch.where(c, av, bv)
        return Dual(vv, torch.where(c, _d(a, vv), _d(b, vv)))
    return torch.where(c, a, b)


def maximum(x, c: float):
    """``max(x, c)`` for a constant c; a tie passes half the tangent (JAX)."""
    if isinstance(x, Dual):
        w = torch.where(x.v > c, 1.0, torch.where(x.v == c, 0.5, 0.0)).to(x.d.dtype)
        return Dual(torch.maximum(x.v, torch.full_like(x.v, c)), x.d * w)
    return torch.maximum(x, torch.full_like(x, c))


def minimum(x, c: float):
    """``min(x, c)`` for a constant c; a tie passes half the tangent (JAX)."""
    if isinstance(x, Dual):
        w = torch.where(x.v < c, 1.0, torch.where(x.v == c, 0.5, 0.0)).to(x.d.dtype)
        return Dual(torch.minimum(x.v, torch.full_like(x.v, c)), x.d * w)
    return torch.minimum(x, torch.full_like(x, c))


# -- stacked 3-vectors and 3x3 matrices ---------------------------------------
# A 3-vector is a tensor [3, *S] and a 3x3 matrix [3, 3, *S] over the batch
# shape S (or a Dual of such). Each product below is written for whole rows
# at once, but every element is the same sequence of scalar operations as
# the device functions of csrc/lanes.cuh: c_i = (a_i0 b_0 + a_i1 b_1) + a_i2 b_2.

def _roll(x, k):
    """Rotate the entries of a stacked 3-vector: (a1, a2, a0) for k = -1."""
    if isinstance(x, Dual):
        return Dual(x.v.roll(k, 0), x.d.roll(k, 0))
    return x.roll(k, 0)


def stack(items, dim=0):
    """``torch.stack`` that carries tangents."""
    if any(isinstance(x, Dual) for x in items):
        vals = [val(x) for x in items]
        return Dual(torch.stack(vals, dim),
                    torch.stack([_d(x, v) for x, v in zip(items, vals)], dim))
    return torch.stack(items, dim)


def const(c, like):
    """A constant vector/matrix as a tensor that broadcasts against stacked
    lanes shaped like ``like`` (the same arithmetic as a lane tensor full of
    each value)."""
    lv = val(like)
    c = np.asarray(c, dtype=np.float64)
    return torch.as_tensor(c, dtype=lv.dtype, device=lv.device).reshape(
        c.shape + (1,) * lv.dim())


def v_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def v_cross(a, b):
    return _roll(a, -1) * _roll(b, -2) - _roll(a, -2) * _roll(b, -1)


def m_vec(A, v):
    """A @ v."""
    return A[:, 0] * v[0] + A[:, 1] * v[1] + A[:, 2] * v[2]


def m_t_vec(A, v):
    """A^T @ v."""
    return A[0] * v[0] + A[1] * v[1] + A[2] * v[2]


def m_mul(A, B):
    """A @ B."""
    return A[:, 0, None] * B[0] + A[:, 1, None] * B[1] + A[:, 2, None] * B[2]


def rot_axis_angle(axis, q):
    """Rodrigues rotation about a constant unit axis by lane angles q."""
    ax, ay, az = float(axis[0]), float(axis[1]), float(axis[2])
    c, s = cos(q), sin(q)
    C = 1.0 - c
    return stack([
        stack([c + ax * ax * C, ax * ay * C - az * s, ax * az * C + ay * s]),
        stack([ay * ax * C + az * s, c + ay * ay * C, ay * az * C - ax * s]),
        stack([az * ax * C - ay * s, az * ay * C + ax * s, c + az * az * C]),
    ])


# -- robot constants ---------------------------------------------------------

class RobotConsts:
    """Numpy (float64) snapshot of a serial-chain robot: the constants the
    CUDA kernels take in their parameter block."""

    def __init__(self, model=None, **fields):
        if model is not None:
            fields = {name: getattr(model, name) for name in self.FIELDS}
        for name in self.FIELDS:
            v = fields[name]
            if name in ("parents", "frame_parents"):
                v = tuple(int(p) for p in v)
            elif isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy().astype(np.float64)
            else:
                v = np.asarray(v, dtype=np.float64)
            setattr(self, name, v)
        self.nj = len(self.parents)

    FIELDS = ("parents", "joint_rot", "joint_pos", "axis", "mass", "com",
              "inertia", "gravity", "frame_parents", "frame_rot", "frame_pos")


# -- kinematics & dynamics ---------------------------------------------------

def fk_lanes(rc: RobotConsts, q):
    """World placements of the joint frames, q a list of lane tensors:
    (rots [3, 3, *S] list, trans [3, *S] list)."""
    rots, trans = [], []
    for i in range(rc.nj):
        E = m_mul(const(rc.joint_rot[i], q[0]), rot_axis_angle(rc.axis[i], q[i]))
        p = const(rc.joint_pos[i], q[0])
        parent = rc.parents[i]
        if parent < 0:
            rots.append(E)
            trans.append(p)
        else:
            rots.append(m_mul(rots[parent], E))
            trans.append(m_vec(rots[parent], p) + trans[parent])
    return rots, trans


def frame_placement_lanes(rc: RobotConsts, rots, trans, fid: int):
    j = rc.frame_parents[fid]
    R = m_mul(rots[j], const(rc.frame_rot[fid], trans[j][0]))
    p = m_vec(rots[j], const(rc.frame_pos[fid], trans[j][0])) + trans[j]
    return R, p


def rnea_lanes(rc: RobotConsts, q, v, a, gravity=True):
    """Inverse dynamics; q/v/a lists of lane tensors -> tau list. ``gravity``
    may be a 0/1 tensor that broadcasts against the lanes (per-lane
    gravity; a lane at 0 computes exactly what ``gravity=False`` does)."""
    like = q[0]
    nj = rc.nj
    zero3 = const(np.zeros(3), like)
    if isinstance(gravity, torch.Tensor):
        g_lin = const(-rc.gravity, like) * gravity
    else:
        g_lin = const(-rc.gravity, like) if gravity else zero3
    Es, ps = [], []
    vs, ws, als, aas = [], [], [], []
    f_lin, f_ang = [None] * nj, [None] * nj

    for i in range(nj):
        E = m_mul(const(rc.joint_rot[i], like), rot_axis_angle(rc.axis[i], q[i]))
        p = const(rc.joint_pos[i], like)
        Es.append(E)
        ps.append(p)
        parent = rc.parents[i]
        if parent < 0:
            vp, wp = zero3, zero3
            ap = g_lin
            alp = zero3
        else:
            vp, wp = vs[parent], ws[parent]
            ap, alp = als[parent], aas[parent]

        vi = m_t_vec(E, vp + v_cross(wp, p))
        wi = m_t_vec(E, wp)
        ai = m_t_vec(E, ap + v_cross(alp, p))
        ali = m_t_vec(E, alp)

        axis = const(rc.axis[i], like)
        wJ = v[i] * axis
        aJ = a[i] * axis

        w_tot = wi + wJ
        vs.append(vi)
        ws.append(w_tot)
        als.append(ai + v_cross(vi, wJ))
        aas.append((ali + aJ) + v_cross(w_tot, wJ))

        m_i = float(rc.mass[i])
        c = const(rc.com[i], like)
        Ic = const(rc.inertia[i], like)

        def apply_inertia(vv, ww):
            h_lin = m_i * (vv + v_cross(ww, c))
            h_ang = m_vec(Ic, ww) + v_cross(c, h_lin)
            return h_lin, h_ang

        h_lin, h_ang = apply_inertia(vs[i], ws[i])
        ha_lin, ha_ang = apply_inertia(als[i], aas[i])
        f_lin[i] = ha_lin + v_cross(ws[i], h_lin)
        f_ang[i] = ha_ang + (v_cross(ws[i], h_ang) + v_cross(vs[i], h_lin))

    tau = [None] * nj
    for i in range(nj - 1, -1, -1):
        tau[i] = v_dot(const(rc.axis[i], like), f_ang[i])
        parent = rc.parents[i]
        if parent >= 0:
            fp = m_vec(Es[i], f_lin[i])
            tp = m_vec(Es[i], f_ang[i]) + v_cross(ps[i], fp)
            f_lin[parent] = f_lin[parent] + fp
            f_ang[parent] = f_ang[parent] + tp
    return tau


def mass_nle_lanes(rc: RobotConsts, q, v):
    """(M rows [nj][nj] of lane tensors, nle list) from unit-accel RNEA.

    The nj + 1 sweeps (nle with gravity, then one unit acceleration each
    without) run as one RNEA over a leading sweep axis; each lane of it
    performs the operations of its separate sweep."""
    like = val(q[0])
    nj = rc.nj
    n = nj + 1
    zero = torch.zeros_like(like)
    qs = [torch.stack([qi] * n) for qi in q]
    vs = [torch.stack([vi] + [zero] * nj) for vi in v]
    acc = [torch.stack([zero] + [torch.ones_like(like) if k == j else zero for k in range(nj)])
           for j in range(nj)]
    gravity = torch.zeros((n,) + (1,) * like.dim(), dtype=like.dtype, device=like.device)
    gravity[0] = 1.0
    tau = rnea_lanes(rc, qs, vs, acc, gravity=gravity)
    nle = [tau[i][0] for i in range(nj)]
    M = [[tau[i][1 + j] for j in range(nj)] for i in range(nj)]
    return M, nle


def solve2(M, b):
    """2x2 lane solve: M rows [[a,b],[c,d]], b list of 2 lanes."""
    a, bb = M[0][0], M[0][1]
    c, d = M[1][0], M[1][1]
    det = a * d - bb * c
    inv_det = 1.0 / det
    return ((d * b[0] - bb * b[1]) * inv_det, (a * b[1] - c * b[0]) * inv_det)


def choln(M):
    """Unrolled n x n lane Cholesky: lower factor as nested lists."""
    n = len(M)
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = M[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = sqrt(s) if i == j else s / L[j][j]
    return L


def choln_solve(L, b):
    """Solve L L^T x = b per lane; b list of n lanes -> list of n lanes."""
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
    return x


def solven(M, b):
    """n x n SPD lane solve: the 2x2 closed form at n=2, else Cholesky."""
    if len(M) == 2:
        return list(solve2(M, b))
    return choln_solve(choln(M), b)


# -- SE(3) log on lanes ------------------------------------------------------

def log3_lanes(R):
    """Axis-angle of a lane rotation matrix with jvp-safe branches.

    ``theta = atan2(|vee|, cos)``; every branch's inputs are sanitized
    (double ``where``) so the tangents of the branches NOT taken stay
    finite — the linearization differentiates through this map, and a
    planar arm crosses theta = pi routinely.
    """
    trace = R[0][0] + R[1][1] + R[2][2]
    cc = minimum(maximum((trace - 1.0) * 0.5, -1.0), 1.0)   # jnp.clip
    u = 1.0 - cc
    s = 1.0 + cc
    vee = ((R[2][1] - R[1][2]) * 0.5, (R[0][2] - R[2][0]) * 0.5, (R[1][0] - R[0][1]) * 0.5)

    small = u < 5e-7
    near_pi = s < 5e-5
    generic = ~(small | near_pi)

    vv = vee[0] * vee[0] + vee[1] * vee[1] + vee[2] * vee[2]
    sin_theta = sqrt(where(generic, vv, 1.0))
    theta = atan2(where(generic, sin_theta, 0.0), where(generic, cc, 1.0))
    fac_gen = theta / sin_theta

    theta2_t = 2.0 * u * (1.0 + u / 6.0)
    fac_small = 1.0 + theta2_t / 6.0

    theta_pi = math.pi - sqrt(maximum(2.0 * s, 1e-30)) * (1.0 + s / 12.0)
    diag = (R[0][0], R[1][1], R[2][2])
    ratio = tuple((d - cc) / maximum(u, 1e-30) for d in diag)
    ax = tuple(where(r > 1e-6, sqrt(where(r > 1e-6, r, 1.0)), 0.0) for r in ratio)
    sgn = tuple(torch.where(vi < 0.0, -1.0, 1.0).to(val(cc).dtype) for vi in vee)
    w_pi = tuple(a * sg * theta_pi for a, sg in zip(ax, sgn))

    fac = where(small, fac_small, fac_gen)
    w_gen = tuple(fac * vi for vi in vee)
    return tuple(where(near_pi, wp, wg) for wp, wg in zip(w_pi, w_gen))


def log6_lanes(R, p):
    """SE(3) log: 6-tuple [v(3); w(3)] of lane tensors."""
    w = log3_lanes(R)
    theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    small = theta2 < 1e-12
    safe_t2 = where(small, 1.0, theta2)
    theta = sqrt(safe_t2)
    sin_t = sin(theta)
    denom = 2.0 * theta * sin_t
    safe_denom = where(absolute(denom) < 1e-12, 1.0, denom)
    k = where(small, 1.0 / 12.0 + theta2 / 720.0,
              1.0 / safe_t2 - (1.0 + cos(theta)) / safe_denom)
    wxp = _cross_t(w, p)
    wxwxp = _cross_t(w, wxp)
    v = tuple(p[i] - 0.5 * wxp[i] + k * wxwxp[i] for i in range(3))
    return v + w


def _cross_t(a, b):
    """Cross product of indexable 3-vectors, as a tuple."""
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])
