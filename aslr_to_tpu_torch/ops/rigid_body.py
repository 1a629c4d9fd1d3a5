"""Rigid-body dynamics: forward kinematics, frame Jacobians, RNEA and its
derivatives, mass matrix, forward dynamics (``aba``).

PyTorch counterpart of ``aslr_to_tpu/ops/rigid_body.py``. The chain
topology is static Python metadata and the per-joint loops unroll; every
function takes joint vectors ``[..., nj]`` and batches over the leading
dims. Spatial 6-vectors are ``[linear; angular]``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .se3 import SE3, jacfwd
from .so3 import exp3, skew


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Fixed-base kinematic chain with revolute joints."""

    name: str
    parents: Tuple[int, ...]
    frame_names: Tuple[str, ...]
    frame_parents: Tuple[int, ...]
    joint_rot: torch.Tensor   # [nj,3,3] fixed rotation of joint frame in parent
    joint_pos: torch.Tensor   # [nj,3]   fixed translation of joint frame in parent
    axis: torch.Tensor        # [nj,3]   revolute axis in the joint frame
    mass: torch.Tensor        # [nj]
    com: torch.Tensor         # [nj,3]   CoM in the joint frame
    inertia: torch.Tensor     # [nj,3,3] rotational inertia about the CoM
    frame_rot: torch.Tensor   # [nf,3,3]
    frame_pos: torch.Tensor   # [nf,3]
    gravity: torch.Tensor     # [3]

    @property
    def nq(self) -> int:
        return len(self.parents)

    @property
    def nv(self) -> int:
        return len(self.parents)

    def frame_id(self, name: str) -> int:
        return self.frame_names.index(name)

    def with_gravity(self, g) -> "RobotModel":
        return dataclasses.replace(self, gravity=torch.as_tensor(
            g, dtype=self.gravity.dtype, device=self.gravity.device))


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _joint_transform(model, i, qi):
    E = model.joint_rot[i] @ exp3(model.axis[i] * qi[..., None])
    return E, model.joint_pos[i]


def _apply_inertia(model, i, v, w):
    m = model.mass[i]
    c = model.com[i]
    Cx = skew(c)
    h_lin = m * (v + torch.linalg.cross(w, c.expand_as(w)))
    h_ang = m * torch.linalg.cross(c.expand_as(v), v) + _mv(model.inertia[i] - m * (Cx @ Cx), w)
    return h_lin, h_ang


def forward_kinematics(model: RobotModel, q):
    """World placements of every joint frame: (rots [...,nj,3,3], trans [...,nj,3])."""
    rots, trans = [], []
    for i, parent in enumerate(model.parents):
        E, p = _joint_transform(model, i, q[..., i])
        if parent < 0:
            rots.append(E)
            trans.append(p.expand(E.shape[:-1]))
        else:
            rots.append(rots[parent] @ E)
            trans.append(_mv(rots[parent], p) + trans[parent])
    return torch.stack(rots, dim=-3), torch.stack(trans, dim=-2)


def frame_placement_from_fk(model: RobotModel, rots, trans, fid: int) -> SE3:
    j = model.frame_parents[fid]
    R = rots[..., j, :, :] @ model.frame_rot[fid]
    p = _mv(rots[..., j, :, :], model.frame_pos[fid]) + trans[..., j, :]
    return SE3(R, p)


def frame_placement(model: RobotModel, q, fid: int) -> SE3:
    rots, trans = forward_kinematics(model, q)
    return frame_placement_from_fk(model, rots, trans, fid)


def frame_jacobian_local_from_fk(model: RobotModel, rots, trans, fid: int):
    """LOCAL frame Jacobian ``[..., 6, nv]`` (``[linear; angular]`` rows)
    from precomputed FK; the columns of joints off the frame's ancestor
    chain are zero."""
    j = model.frame_parents[fid]
    oMf = frame_placement_from_fk(model, rots, trans, fid)
    fRt = oMf.rot.transpose(-1, -2)
    support = set()
    k = j
    while k >= 0:
        support.add(k)
        k = model.parents[k]
    cols = []
    for i in range(model.nv):
        if i in support:
            w_world = _mv(rots[..., i, :, :], model.axis[i])
            v_world = torch.linalg.cross(w_world, oMf.trans - trans[..., i, :])
            cols.append(torch.cat([_mv(fRt, v_world), _mv(fRt, w_world)], dim=-1))
        else:
            cols.append(torch.zeros(trans.shape[:-2] + (6,), dtype=trans.dtype,
                                    device=trans.device))
    return torch.stack(cols, dim=-1)


def frame_jacobian_local(model: RobotModel, q, fid: int):
    """LOCAL frame Jacobian at ``q [..., nq]``."""
    rots, trans = forward_kinematics(model, q)
    return frame_jacobian_local_from_fk(model, rots, trans, fid)


def rnea(model: RobotModel, q, v, a, gravity: bool = True):
    """Inverse dynamics: joint torques ``[..., nj]`` for (q, v, a)."""
    nj = model.nq
    zero3 = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
    g_lin = (-model.gravity).expand_as(zero3) if gravity else zero3
    cross = torch.linalg.cross

    Es, ps = [], []
    vs, ws, a_lin, a_ang = [], [], [], []
    f_lin, f_ang = [None] * nj, [None] * nj
    for i, parent in enumerate(model.parents):
        E, p = _joint_transform(model, i, q[..., i])
        p = p.expand_as(zero3)
        Es.append(E)
        ps.append(p)
        if parent < 0:
            vp, wp, ap, alp = zero3, zero3, g_lin, zero3
        else:
            vp, wp = vs[parent], ws[parent]
            ap, alp = a_lin[parent], a_ang[parent]
        Et = E.transpose(-1, -2)
        vi, wi = _mv(Et, vp + cross(wp, p)), _mv(Et, wp)
        ai, ali = _mv(Et, ap + cross(alp, p)), _mv(Et, alp)
        wJ = model.axis[i] * v[..., i, None]
        aJ = model.axis[i] * a[..., i, None]
        w_tot = wi + wJ
        cv = cross(w_tot, zero3) + cross(vi, wJ)
        cw = cross(w_tot, wJ)
        vs.append(vi)
        ws.append(w_tot)
        a_lin.append(ai + cv)
        a_ang.append(ali + aJ + cw)

        h_lin, h_ang = _apply_inertia(model, i, vs[i], ws[i])
        ha_lin, ha_ang = _apply_inertia(model, i, a_lin[i], a_ang[i])
        f_lin[i] = ha_lin + cross(ws[i], h_lin)
        f_ang[i] = ha_ang + (cross(ws[i], h_ang) + cross(vs[i], h_lin))

    tau = [None] * nj
    for i in range(nj - 1, -1, -1):
        tau[i] = (model.axis[i] * f_ang[i]).sum(-1)
        parent = model.parents[i]
        if parent >= 0:
            fp = _mv(Es[i], f_lin[i])
            f_lin[parent] = f_lin[parent] + fp
            f_ang[parent] = f_ang[parent] + (_mv(Es[i], f_ang[i]) + cross(ps[i], fp))
    return torch.stack(tau, dim=-1)


def nonlinear_effects(model: RobotModel, q, v):
    """Coriolis + gravity torques."""
    return rnea(model, q, v, torch.zeros_like(q), gravity=True)


def mass_matrix(model: RobotModel, q):
    """Joint-space inertia matrix ``[..., nv, nv]`` from unit-acceleration
    RNEA columns (one RNEA over a new leading dim of the nv unit
    accelerations), symmetrized."""
    nv = model.nv
    qs = q.expand((nv,) + q.shape)
    eye = torch.eye(nv, dtype=q.dtype, device=q.device)
    e = eye.reshape((nv,) + (1,) * (q.dim() - 1) + (nv,)).expand_as(qs)
    M = rnea(model, qs, torch.zeros_like(qs), e, gravity=False).movedim(0, -1)
    return 0.5 * (M + M.transpose(-1, -2))


def compute_all_terms(model: RobotModel, q, v):
    """(M, nle) in one call."""
    return mass_matrix(model, q), nonlinear_effects(model, q, v)


def rnea_derivatives(model: RobotModel, q, v, a):
    """(dtau_dq, dtau_dv) ``[..., nv, nv]`` of the inverse dynamics, by
    forward mode through ``rnea``."""
    dtau_dq = jacfwd(lambda q_: rnea(model, q_, v.expand_as(q_), a.expand_as(q_)), q)
    dtau_dv = jacfwd(lambda v_: rnea(model, q.expand_as(v_), v_, a.expand_as(v_)), v)
    return dtau_dq, dtau_dv


def aba(model: RobotModel, q, v, tau):
    """Forward dynamics accelerations ``M(q)^-1 (tau - nle(q, v))`` (the
    reference's ``pinocchio.aba``) by a dense solve; NaN where M is
    singular, as ``jnp.linalg.solve`` gives, instead of raising."""
    M, b = compute_all_terms(model, q, v)
    rhs = tau - b
    a, info = torch.linalg.solve_ex(M.expand(rhs.shape[:-1] + M.shape[-2:]), rhs)
    return torch.where((info == 0)[..., None], a, torch.nan)
