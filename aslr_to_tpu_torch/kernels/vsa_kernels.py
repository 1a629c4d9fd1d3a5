"""Linearization (K1), two-trial rollout (K3) and one-trial rollout (K6) of
the soft arm (VSA or SEA), and the per-scenario solver's fast path.

PyTorch counterpart of ``aslr_to_tpu/pallas/vsa_kernels.py``. Each
wrapper takes tensors in lane layout (batch innermost: ``[..., B]``,
contiguous, unpadded). On a CUDA tensor it launches its hand-written
kernel (``csrc/linearize.cu``, ``csrc/rollout.cu``) or raises; on a CPU
tensor it runs its plain PyTorch version, which follows the kernel's order
of operations and is what the CPU tests hold against the JAX package.
``build_fast_path`` wraps K1 and K6 for ``solvers/ddp.py::solve``, whose
tensors are batch-major (``[B, ...]``), relayouting at each call.

Specialization contract (checked by :func:`extract_vsa_spec`): the VSA
dynamics (u = [tau_m, k]) or the SEA dynamics with the ASR actuation (u =
tau_m, a constant spring matrix K) on a serial revolute chain, the Euler
integrator, a frame-placement goal plus weighted state and control
regularizers (and an optional linear stiffness cost), a goal-only terminal
cost, and a shared ``[nu]`` control box or none. A per-knot problem may
vary its frame target from knot to knot (K1, K3 and K6 then read a ``[T,
12]`` target table, :meth:`VSASpec.target_table`) and its control box (K2,
K3, K5 and K6 then read ``[T, nu]`` box tables); nothing else.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import lanes
from ..ops.lanes import RobotConsts
from . import build as _build


class VSASpec(NamedTuple):
    """Concrete (numpy, float64) snapshot of the workload the kernels
    specialize on; the fields of ``aslr_to_tpu``'s ``VSASpec``."""

    rc: RobotConsts
    dt: float
    binv: np.ndarray            # [nl, nl] inverse motor inertia
    frame_id: int
    target_rot_inv: np.ndarray  # [3, 3] target inverse rotation ([T, 3, 3] per-knot)
    target_pos: np.ndarray      # [3] target translation ([T, 3] per-knot)
    w_goal: float
    w_goal_term: float
    xw: np.ndarray              # [4 nl] combined state-reg weights
    uw: np.ndarray              # [nu] combined control-reg weights
    stiff_w: float              # combined linear stiffness weight
    stiff_ref: np.ndarray       # [nl] stiffness reference
    lb: Optional[np.ndarray]    # [nu] (None: unbounded; [T, nu] per-knot box)
    ub: Optional[np.ndarray]
    variant: str = "vsa"
    K: Optional[np.ndarray] = None
    nu: int = 4
    nl: int = 2
    term_target_rot_inv: Optional[np.ndarray] = None   # [3, 3] when it differs
    term_target_pos: Optional[np.ndarray] = None       # [3]

    @property
    def ndx(self) -> int:
        return 4 * self.nl

    @property
    def per_knot_target(self) -> bool:
        return self.target_rot_inv is not None and np.ndim(self.target_rot_inv) == 3

    @property
    def per_knot_box(self) -> bool:
        return self.lb is not None and np.ndim(self.lb) == 2

    def target_table(self, T: int, dtype) -> np.ndarray:
        """[T, 12] per-knot target rows (flattened R_inv | pos), the
        kernels' table; broadcast when the target is shared. ``dtype`` a
        numpy or a torch dtype."""
        if isinstance(dtype, torch.dtype):
            dtype = torch.empty(0, dtype=dtype).numpy().dtype
        Ri = np.asarray(self.target_rot_inv, dtype=np.float64)
        tp = np.asarray(self.target_pos, dtype=np.float64)
        if not self.per_knot_target:
            Ri = np.broadcast_to(Ri, (T, 3, 3))
            tp = np.broadcast_to(tp, (T, 3))
        return np.concatenate([Ri.reshape(T, 9), tp.reshape(T, 3)], axis=1).astype(dtype)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().astype(np.float64)
    return np.asarray(a, dtype=np.float64)


def extract_vsa_spec(problem, bounds) -> VSASpec:
    """Introspect a concrete ShootingProblem built from the VSA presets.

    Per-knot problems (``problem.per_knot``) are covered when the
    knot-to-knot variation is limited to the frame-placement target (a
    time-varying tracking target) and/or the control box (``[T, nu]``
    Bounds); any other varying leaf raises TypeError, and the problem runs
    on the generic route."""
    per_knot = bool(problem.per_knot)
    T = problem.T

    def const(leaf, what):
        """A per-knot leaf (stacked [T, ...] by ``stack_knots``) must be
        constant across knots: only the frame target and the control box
        may vary."""
        a = _np(leaf)
        if per_knot and a.ndim >= 1 and a.shape[0] == T:
            if not np.all(a == a[:1]):
                raise TypeError(f"fast path requires knot-constant {what}; "
                                "only the frame target and the control box "
                                "may vary per knot")
            a = a[0]
        return a

    if bounds is not None and np.ndim(_np(bounds.lb)) not in (1, 2):
        raise TypeError("bounds must be [nu] shared or [T, nu] per-knot")
    from ..models.actuation import ASRActuation
    from ..models.costs import (
        ActivationModelQuad,
        ActivationModelWeightedQuad,
        CostModelResidual,
        CostModelStiffness,
        ResidualModelControl,
        ResidualModelFramePlacementASR,
        ResidualModelState,
    )
    from ..models.dynamics import DifferentialSEADynamics, DifferentialVSADynamics

    running = problem.running
    diff = running.differential
    robot = problem.knot_model(0).differential.state.robot
    nl = int(robot.nv)
    if isinstance(diff, DifferentialVSADynamics):
        variant, nu, K = "vsa", 2 * nl, None
    elif isinstance(diff, DifferentialSEADynamics):
        if not isinstance(diff.actuation, ASRActuation):
            raise TypeError("SEA fast path requires ASRActuation")
        variant, nu, K = "sea", nl, const(diff.K, "spring matrix")
    else:
        raise TypeError("fast path requires VSA or SEA dynamics")

    def act_weights(cost, nr):
        if isinstance(cost.activation, ActivationModelQuad):
            return np.ones(nr)
        if isinstance(cost.activation, ActivationModelWeightedQuad):
            return const(cost.activation.weights, "activation weights")
        raise TypeError(f"unsupported activation {type(cost.activation)}")

    w_goal = w_goal_term = 0.0
    xw, uw = np.zeros(4 * nl), np.zeros(nu)
    stiff_w, stiff_ref = 0.0, np.zeros(nl)
    frame_id = None
    target_rot, target_pos = np.eye(3), np.zeros(3)
    for it in diff.costs.items:
        c = it.cost
        w = float(const(it.weight, "cost weight"))
        if isinstance(c, CostModelStiffness):
            stiff_w += w * float(const(c.lamda, "stiffness lamda"))
            if c.Kref is not None:
                stiff_ref = const(c.Kref, "stiffness reference")
            continue
        if not isinstance(c, CostModelResidual):
            raise TypeError(f"unsupported running cost {type(c)}")
        r = c.residual
        if isinstance(r, ResidualModelFramePlacementASR):
            w_goal += w
            frame_id = int(r.frame_id)
            # the only leaves allowed to vary per knot: the frame target
            target_rot, target_pos = _np(r.placement.rot), _np(r.placement.trans)
            if per_knot and np.all(target_rot == target_rot[:1]) \
                    and np.all(target_pos == target_pos[:1]):
                target_rot, target_pos = target_rot[0], target_pos[0]
            if not np.allclose(act_weights(c, 6), 1.0):
                raise TypeError("goal activation must be plain quad")
        elif isinstance(r, ResidualModelState):
            if not np.allclose(const(r.xref, "state reference"), 0.0):
                raise TypeError("fast path assumes zero state reference")
            xw += w * act_weights(c, 4 * nl)
        elif isinstance(r, ResidualModelControl):
            uw += w * act_weights(c, nu)
        else:
            raise TypeError(f"unsupported residual {type(r)}")

    term_rot = term_pos = None
    for it in problem.terminal.differential.costs.items:
        c = it.cost
        if isinstance(c, CostModelResidual) and isinstance(c.residual, ResidualModelFramePlacementASR):
            w_goal_term += float(it.weight)
            term_rot, term_pos = _np(c.residual.placement.rot), _np(c.residual.placement.trans)
        else:
            raise TypeError("fast path assumes goal-only terminal cost")

    per_knot_target = target_rot.ndim == 3
    if per_knot_target and target_rot.shape[0] != T:
        raise TypeError("per-knot target must have one row per knot")
    # the terminal target apart only where it differs from the running one
    if term_rot is not None and not per_knot_target and \
            np.array_equal(term_rot, target_rot) and np.array_equal(term_pos, target_pos):
        term_rot = term_pos = None
    if per_knot_target and term_rot is None:
        # no terminal placement cost (w_goal_term = 0): the (weight-0)
        # terminal goal at the last knot's target
        term_rot, term_pos = target_rot[-1], target_pos[-1]

    lb = None if bounds is None else _np(bounds.lb)
    ub = None if bounds is None else _np(bounds.ub)
    if lb is not None and lb.ndim == 2 and lb.shape[0] != T:
        raise TypeError("per-knot bounds must be [T, nu]")

    return VSASpec(
        rc=RobotConsts(robot),
        dt=float(const(running.dt, "time step")),
        binv=np.linalg.inv(const(diff.B, "motor inertia")),
        frame_id=frame_id,
        target_rot_inv=np.swapaxes(target_rot, -1, -2),
        target_pos=target_pos,
        w_goal=w_goal,
        w_goal_term=w_goal_term,
        xw=xw,
        uw=uw,
        stiff_w=stiff_w,
        stiff_ref=stiff_ref,
        lb=lb,
        ub=ub,
        variant=variant,
        K=K,
        nu=nu,
        nl=nl,
        term_target_rot_inv=None if term_rot is None else term_rot.T,
        term_target_pos=term_pos,
    )


def _term_target(spec):
    if spec.term_target_rot_inv is not None:
        return spec.term_target_rot_inv, spec.term_target_pos
    return spec.target_rot_inv, spec.target_pos


def _shared_target(spec):
    """The parameter block's running target: the shared one, or a per-knot
    target's first row (the kernels then read the table instead)."""
    if spec.per_knot_target:
        return spec.target_rot_inv[0], spec.target_pos[0]
    return spec.target_rot_inv, spec.target_pos


def pack_params(spec: VSASpec) -> np.ndarray:
    """The kernels' parameter block: a flat float64 array in the field order
    of ``csrc/common.cuh::unpack_params``. The control weights are padded to
    2 nl; the SEA's flag and spring matrix close the block (zeros for the
    VSA)."""
    if spec.variant not in ("vsa", "sea"):
        raise ValueError(f"unknown actuation variant {spec.variant!r}")
    sea = spec.variant == "sea"
    rc = spec.rc
    nl = spec.nl
    if rc.parents != tuple(range(-1, nl - 1)):
        raise NotImplementedError("the kernels take serial chains (parent of joint i is i-1)")
    fid = spec.frame_id
    term_rinv, term_pos = _term_target(spec)
    tgt_rinv, tgt_pos = _shared_target(spec)
    parts = [
        [spec.dt], spec.binv, rc.joint_rot, rc.joint_pos, rc.axis, rc.mass, rc.com,
        rc.inertia, rc.gravity, [rc.frame_parents[fid]], rc.frame_rot[fid],
        rc.frame_pos[fid], tgt_rinv, tgt_pos, term_rinv, term_pos,
        [spec.w_goal], spec.xw, np.pad(spec.uw, (0, 2 * nl - spec.nu)), [spec.stiff_w],
        spec.stiff_ref, [1.0 if sea else 0.0], spec.K if sea else np.zeros((nl, nl)),
    ]
    return np.ascontiguousarray(np.concatenate(
        [np.asarray(p, dtype=np.float64).ravel() for p in parts]))


def _params_ptr(spec):
    arr = pack_params(spec)
    return arr, arr.ctypes.data_as(_build.ctypes.c_void_p)


def _check_lane(name, t, shape, dtype, device):
    if t.shape != shape:
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype or t.device != device:
        raise ValueError(f"{name}: expected {dtype} on {device}, got {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def to_lanes(x):
    """``[B, ...]`` -> the kernels' lane layout ``[..., B]``: always a copy,
    also of a tensor that is a permuted view of one in lane layout (a lane
    solve's result, the next homotopy stage's start)."""
    return x.permute(*range(1, x.dim()), 0).clone(memory_format=torch.contiguous_format)


def from_lanes(x):
    """``[..., B]`` -> batch-major ``[B, ...]`` (a copy)."""
    return x.permute(x.dim() - 1, *range(x.dim() - 1)).contiguous()


def _opt(t):
    """A kernel's pointer argument: the tensor's, or null for None."""
    return None if t is None else _build.ptr(t)


def _route(t):
    """'kernel' for a CUDA tensor, 'plain' for a CPU tensor; else raise."""
    if t.is_cuda:
        return "kernel"
    if t.device.type == "cpu":
        return "plain"
    raise ValueError(f"no kernel or plain route for device {t.device}")


# ---------------------------------------------------------------------------
# shared lane pieces (the plain versions' counterparts of csrc/lanes.cuh)
# ---------------------------------------------------------------------------

def _dot_terms(terms):
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def _dynamics_lanes(spec, x, u):
    """Soft-arm accelerations: x list of 4 nl lanes, u list of nu lanes ->
    2 nl lanes; also returns M and tau_c. VSA: tau_c = k (q_l - q_m); SEA:
    tau_c = K (q_l - q_m)."""
    nl = spec.nl
    q_l, q_m, v_l = list(x[:nl]), list(x[nl:2 * nl]), list(x[2 * nl:3 * nl])
    if spec.variant == "sea":
        d = [q_l[i] - q_m[i] for i in range(nl)]
        tau_c = [_dot_terms([float(spec.K[i][j]) * d[j] for j in range(nl)])
                 for i in range(nl)]
    else:
        kd = list(u[nl:2 * nl])
        tau_c = [kd[i] * (q_l[i] - q_m[i]) for i in range(nl)]
    M, nle = lanes.mass_nle_lanes(spec.rc, q_l, v_l)
    a_l = lanes.solven(M, [-nle[i] - tau_c[i] for i in range(nl)])
    binv = spec.binv
    a_m = [_dot_terms([float(binv[i][j]) * (u[j] + tau_c[j]) for j in range(nl)])
           for i in range(nl)]
    return list(a_l) + a_m, M, tau_c


def _table_target(tab, like, t=None):
    """(R_inv [3, 3, ...], pos [3, ...]) of a target table ``tab [T, 12]``
    as constants that broadcast against lanes shaped like ``like``: row
    ``t`` (one knot's lanes), or every row along the lanes' leading knot
    axis (``t`` None: lanes ``[T, ...]``)."""
    lv = lanes.val(like)
    if t is not None:
        lead = (1,) * lv.dim()
        return tab[t, :9].reshape((3, 3) + lead), tab[t, 9:].reshape((3,) + lead)
    rest = (1,) * (lv.dim() - 1)
    cols = tab.T                                        # [12, T]
    return (cols[:9].reshape((3, 3, tab.shape[0]) + rest),
            cols[9:].reshape((3, tab.shape[0]) + rest))


def _goal_cost_lanes(spec, q_l, terminal=False, tgt=None):
    """0.5 * || log6(target^-1 oMf) ||^2 on lanes, and the residual r6.
    ``tgt``: the knot's (R_inv, pos) from :func:`_table_target`; None takes
    the spec's running (or ``terminal``) target."""
    rots, trans = lanes.fk_lanes(spec.rc, q_l)
    R, p = lanes.frame_placement_lanes(spec.rc, rots, trans, spec.frame_id)
    if tgt is None:
        Ri_np, tp_np = _term_target(spec) if terminal else _shared_target(spec)
        tgt = lanes.const(Ri_np, q_l[0]), lanes.const(tp_np, q_l[0])
    Ri, tp = tgt
    rM = lanes.m_mul(Ri, R)
    rp = lanes.m_vec(Ri, p - tp)
    r6 = lanes.log6_lanes(rM, rp)
    return 0.5 * sum(ri * ri for ri in r6), r6


def _reg_cost(spec, x, u, c):
    for i in range(spec.ndx):
        if spec.xw[i] != 0.0:
            c = c + 0.5 * float(spec.xw[i]) * x[i] * x[i]
    for i in range(spec.nu):
        if spec.uw[i] != 0.0:
            c = c + 0.5 * float(spec.uw[i]) * u[i] * u[i]
    if spec.stiff_w != 0.0:
        for i in range(spec.nl):
            c = c + float(spec.stiff_w) * (u[spec.nl + i] - float(spec.stiff_ref[i]))
    return c


def _running_cost_lanes(spec, x, u, tgt=None):
    c_goal, _ = _goal_cost_lanes(spec, list(x[:spec.nl]), tgt=tgt)
    return _reg_cost(spec, x, u, float(spec.w_goal) * c_goal)


def _euler(spec, x, a):
    nv = spec.ndx // 2
    dt = spec.dt
    return ([x[i] + x[nv + i] * dt + a[i] * dt * dt for i in range(nv)]
            + [x[nv + i] + a[i] * dt for i in range(nv)])


# ---------------------------------------------------------------------------
# K1: linearization
# ---------------------------------------------------------------------------

class Linearization(NamedTuple):
    cost: torch.Tensor   # [B] summed over the knots, terminal included
    run: dict            # Fx [T,ndx,ndx,B], Fu [T,ndx,nu,B], Lx, Lu, Lxx, Lxu, Luu
    term: dict           # Lx [ndx,B], Lxx [ndx,ndx,B]
    xnext: torch.Tensor  # [T, ndx, B]
    ok: torch.Tensor     # [B] bool: every derivative tensor finite


def _goal_jacobian(spec, q_l, terminal, tgt=None):
    """(c_goal, r6, J) with J[c][k] = d r6_k / d q_l_c from nl jvp seeds."""
    c_goal, r6 = _goal_cost_lanes(spec, q_l, terminal, tgt)

    J = []
    for j in range(spec.nl):
        qd = [lanes.Dual(q, torch.ones_like(q) if i == j else torch.zeros_like(q))
              for i, q in enumerate(q_l)]
        J.append([lanes.tangent(r) for r in _goal_cost_lanes(spec, qd, terminal, tgt)[1]])
    return c_goal, r6, J


def _cost_derivs(spec, x, u, w_goal, J, r6, terminal):
    NDX, NU, NL = spec.ndx, spec.nu, spec.nl
    zero = torch.zeros_like(x[0])
    Lx = []
    for i in range(NDX):
        v = zero
        if i < NL:
            for kk in range(6):
                v = v + w_goal * J[i][kk] * r6[kk]
        if not terminal and spec.xw[i] != 0.0:
            v = v + float(spec.xw[i]) * x[i]
        Lx.append(v)
    Lxx = []
    for i in range(NDX):
        row = []
        for j in range(NDX):
            v = zero
            if i < NL and j < NL:
                for kk in range(6):
                    v = v + w_goal * J[i][kk] * J[j][kk]
            if i == j and not terminal and spec.xw[i] != 0.0:
                v = v + float(spec.xw[i])
            row.append(v)
        Lxx.append(torch.stack(row))
    if terminal:
        return torch.stack(Lx), torch.stack(Lxx)
    Lu = []
    for j in range(NU):
        v = zero
        if spec.uw[j] != 0.0:
            v = v + float(spec.uw[j]) * u[j]
        if spec.stiff_w != 0.0 and j >= NL:
            v = v + float(spec.stiff_w)
        Lu.append(v)
    Luu = torch.stack([torch.stack([zero + float(spec.uw[i]) if (i == j and spec.uw[i] != 0.0)
                                    else zero for j in range(NU)]) for i in range(NU)])
    Lxu = torch.zeros((NDX, NU) + zero.shape, dtype=zero.dtype, device=zero.device)
    return torch.stack(Lx), torch.stack(Lxx), torch.stack(Lu), Lxu, Luu


def _acc_jacobian_cols(spec, x, u, a, M):
    """Columns d a / d [q_l, q_m, v_l, v_m, tau] and, for the VSA, [k]
    (vsa_kernels.py:855-928)."""
    NL = spec.nl
    sea = spec.variant == "sea"
    q_l, q_m, v_l = list(x[:NL]), list(x[NL:2 * NL]), list(x[2 * NL:3 * NL])
    a_l = list(a[:NL])
    zero = torch.zeros_like(x[0])
    one = torch.ones_like(x[0])
    binv = [[float(b) for b in row] for row in spec.binv]

    if NL == 2:
        det = M[0][0] * M[1][1] - M[0][1] * M[1][0]
        idet = 1.0 / det
        Minv = [[M[1][1] * idet, -M[0][1] * idet], [-M[1][0] * idet, M[0][0] * idet]]

        def msolve(col):
            return [Minv[0][0] * col[0] + Minv[0][1] * col[1],
                    Minv[1][0] * col[0] + Minv[1][1] * col[1]]

        def msolve_basis(j, s):
            return [Minv[0][j] * s, Minv[1][j] * s]
    else:
        Lfac = lanes.choln(M)

        def msolve(col):
            return lanes.choln_solve(Lfac, list(col))

        def msolve_basis(j, s):
            return msolve([s if i == j else zero for i in range(NL)])

    # RNEA partials at (q_l, v_l, a_l): nl dual seeds each
    dtau_dq, dtau_dv = [], []
    for j in range(NL):
        qd = [lanes.Dual(q_l[i], one if i == j else zero) for i in range(NL)]
        vd = [lanes.Dual(v_l[i], one if i == j else zero) for i in range(NL)]
        dtau_dq.append([lanes.tangent(t) for t in lanes.rnea_lanes(spec.rc, qd, v_l, a_l)])
        dtau_dv.append([lanes.tangent(t) for t in lanes.rnea_lanes(spec.rc, q_l, vd, a_l)])

    # dK_col[j][i] = d tau_c_i / d q_l_j
    if sea:
        dK_col = [[float(spec.K[i][j]) * one for i in range(NL)] for j in range(NL)]
    else:
        kd = list(u[NL:2 * NL])
        dK_col = [[(kd[j] if i == j else zero) for i in range(NL)] for j in range(NL)]

    def binv_apply(col):
        return [_dot_terms([binv[i][j2] * col[j2] for j2 in range(NL)]) for i in range(NL)]

    cols = []
    for j in range(NL):
        cols.append(msolve([-(dtau_dq[j][i]) - dK_col[j][i] for i in range(NL)])
                    + binv_apply(dK_col[j]))
    for j in range(NL):
        cols.append(msolve(list(dK_col[j])) + [-m for m in binv_apply(dK_col[j])])
    for j in range(NL):
        cols.append(msolve([-dtau_dv[j][i] for i in range(NL)]) + [zero] * NL)
    for j in range(NL):
        cols.append([zero] * (2 * NL))
    for j in range(NL):
        cols.append([zero] * NL + [binv[i][j] * one for i in range(NL)])
    if not sea:
        for j in range(NL):
            d = q_l[j] - q_m[j]
            cols.append(msolve_basis(j, -d) + [binv[i][j] * d for i in range(NL)])
    return cols


def _all_finite(t, nlead):
    """Per-lane finiteness over the ``nlead`` leading (matrix) axes."""
    return torch.isfinite(t).flatten(0, nlead - 1).all(0)


def _need_table(spec, tgt):
    if spec.per_knot_target and tgt is None:
        raise ValueError("a per-knot target: pass its table, spec.target_table(T, dtype)")


def linearize_plain(spec: VSASpec, xs, us, wterm, tgt=None) -> Linearization:
    """Plain PyTorch version of K1 on lane tensors ``xs [T+1, ndx, B]``,
    ``us [T, nu, B]``, ``wterm [B]``, and the target table ``tgt [T, 12]``
    (None: the spec's shared target); the RNEA and goal partials come from
    dual numbers (``ops/lanes.py::Dual``). Elementwise only (no matrix
    product)."""
    _need_table(spec, tgt)
    NDX, NU, NL = spec.ndx, spec.nu, spec.nl
    dt = spec.dt
    # running knots: lanes of shape [T, B]
    x = [xs[:-1, i] for i in range(NDX)]
    u = [us[:, j] for j in range(NU)]
    a, M, _ = _dynamics_lanes(spec, x, u)
    cols = _acc_jacobian_cols(spec, x, u, a, M)
    knot_tgt = None if tgt is None else _table_target(tgt, x[0])
    c_goal, r6, J = _goal_jacobian(spec, x[:NL], False, knot_tgt)
    w_goal = float(spec.w_goal)
    cost_t = _reg_cost(spec, x, u, w_goal * c_goal)
    Lx, Lxx, Lu, Lxu, Luu = _cost_derivs(spec, x, u, w_goal, J, r6, terminal=False)

    nv = NDX // 2
    Fx_rows = []
    for i in range(NDX):
        row = []
        for j in range(NDX):
            if i < nv:
                v = cols[j][i] * (dt * dt)
                if i == j:
                    v = v + 1.0
                if j == i + nv:
                    v = v + dt
            else:
                v = cols[j][i - nv] * dt
                if i == j:
                    v = v + 1.0
            row.append(v)
        Fx_rows.append(torch.stack(row))
    Fu_rows = [torch.stack([(cols[NDX + j][i] * (dt * dt)) if i < nv else cols[NDX + j][i - nv] * dt
                            for j in range(NU)]) for i in range(NDX)]
    Fx_s, Fu_s = torch.stack(Fx_rows), torch.stack(Fu_rows)     # [rows, cols, T, B]
    ok_t = (_all_finite(Fx_s, 2) & _all_finite(Fu_s, 2) & _all_finite(Lx, 1)
            & _all_finite(Lu, 1) & _all_finite(Lxx, 2))
    # lane layout: [T, rows, (cols,) B]
    run = dict(Fx=Fx_s.permute(2, 0, 1, 3).contiguous(),
               Fu=Fu_s.permute(2, 0, 1, 3).contiguous(),
               Lx=Lx.permute(1, 0, 2).contiguous(), Lu=Lu.permute(1, 0, 2).contiguous(),
               Lxx=Lxx.permute(2, 0, 1, 3).contiguous(),
               Lxu=Lxu.permute(2, 0, 1, 3).contiguous(),
               Luu=Luu.permute(2, 0, 1, 3).contiguous())
    xnext = torch.stack(_euler(spec, x, a)).transpose(0, 1).contiguous()

    # terminal knot: lanes of shape [B]
    xT = [xs[-1, i] for i in range(NDX)]
    tc_goal, tr6, tJ = _goal_jacobian(spec, xT[:NL], terminal=True)
    tLx, tLxx = _cost_derivs(spec, xT, None, wterm, tJ, tr6, terminal=True)
    tcost = wterm * tc_goal
    tok = _all_finite(tLx, 1) & _all_finite(tLxx, 2)
    return Linearization(cost=cost_t.sum(0) + tcost, run=run, term=dict(Lx=tLx, Lxx=tLxx),
                         xnext=xnext, ok=ok_t.all(0) & tok)


def linearize(spec: VSASpec, xs, us, wterm, tgt=None) -> Linearization:
    """K1 on lane tensors: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. ``tgt [T, 12]``: the target table, which the
    running knots read row by row (needed for a per-knot target; given for
    a shared one, it takes the table's branch of the kernel)."""
    if _route(xs) == "plain":
        return linearize_plain(spec, xs, us, wterm, tgt)
    _need_table(spec, tgt)
    T, NDX, B = us.shape[0], spec.ndx, xs.shape[-1]
    NU = spec.nu
    dt, dev = xs.dtype, xs.device
    _build.require("linearize", f"nl={spec.nl} {spec.variant}")
    _check_lane("xs", xs, (T + 1, NDX, B), dt, dev)
    _check_lane("us", us, (T, NU, B), dt, dev)
    _check_lane("wterm", wterm, (B,), dt, dev)
    if tgt is not None:
        _check_lane("tgt", tgt, (T, 12), dt, dev)

    def e(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device=dev)

    run = dict(Fx=e(T, NDX, NDX, B), Fu=e(T, NDX, NU, B), Lx=e(T, NDX, B), Lu=e(T, NU, B),
               Lxx=e(T, NDX, NDX, B), Lxu=e(T, NDX, NU, B), Luu=e(T, NU, NU, B))
    xnext, cost_t, ok_t = e(T, NDX, B), e(T, B), e(T, B, dtype=torch.bool)
    term = dict(Lx=e(NDX, B), Lxx=e(NDX, NDX, B))
    tcost, tok = e(B), e(B, dtype=torch.bool)
    params, pp = _params_ptr(spec)
    p = _build.ptr
    code = _build.entry("aslr_linearize", dt, spec.nl)(
        pp, spec.nl, p(xs), p(us), p(wterm), _opt(tgt), T, B,
        *[p(run[k]) for k in ("Fx", "Fu", "Lx", "Lu", "Lxx", "Lxu", "Luu")],
        p(xnext), p(cost_t), p(ok_t), p(term["Lx"]), p(term["Lxx"]), p(tcost), p(tok),
        _build.stream_of(xs))
    _build.check("linearize", code, f"nl={spec.nl} {spec.variant}")
    return Linearization(cost=cost_t.sum(0) + tcost, run=run, term=term, xnext=xnext,
                         ok=ok_t.all(0) & tok)


# ---------------------------------------------------------------------------
# K3: two-trial rollout
# ---------------------------------------------------------------------------

class Trial(NamedTuple):
    xs: torch.Tensor     # [T+1, ndx, B]
    us: torch.Tensor     # [T, nu, B]
    cost: torch.Tensor   # [B]


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _rollout_plain(spec: VSASpec, xs, us, k, K, x0, alpha, wterm, lb, ub, fs, infeas, tgt):
    """The trials of ``alpha [n, B]`` advance together as lanes of shape
    ``[n, B]``, one knot at a time, each with the operations of one
    kernel thread. ``lb``/``ub`` None: no clip, ``[nu, B]``: a box a lane,
    ``[T, nu]`` (``spec.per_knot_box``): row t clips knot t;
    ``fs``/``infeas`` given: the gap contraction; ``tgt [T, 12]``: the
    running cost's target table."""
    _need_table(spec, tgt)
    T, NDX, NU = us.shape[0], spec.ndx, spec.nu
    n = alpha.shape[0]
    gaps = fs is not None
    if gaps:
        gscale = (alpha - 1.0) * infeas
        x = [x0[i] + fs[0, i] * gscale for i in range(NDX)]
    else:
        x = [torch.stack([x0[i]] * n) for i in range(NDX)]
    xs_out, us_out = [torch.stack(x)], []
    cost = torch.zeros_like(alpha)
    for t in range(T):
        dx = [x[i] - xs[t, i] for i in range(NDX)]
        u = []
        for j in range(NU):
            fb = k[t, j] * alpha
            for i in range(NDX):
                fb = fb + K[t, j, i] * dx[i]
            u_j = us[t, j] - fb
            if spec.per_knot_box:
                u_j = _clip(u_j, lb[t, j], ub[t, j])
            elif lb is not None:
                u_j = _clip(u_j, lb[j], ub[j])
            u.append(u_j)
        a, _, _ = _dynamics_lanes(spec, x, u)
        knot_tgt = None if tgt is None else _table_target(tgt, x[0], t)
        cost = cost + _running_cost_lanes(spec, x, u, knot_tgt)
        x = _euler(spec, x, a)
        if gaps:
            x = [x[i] + fs[t + 1, i] * gscale for i in range(NDX)]
        xs_out.append(torch.stack(x))
        us_out.append(torch.stack(u))
    c_goal_T, _ = _goal_cost_lanes(spec, x[:spec.nl], terminal=True)
    cost = cost + wterm * c_goal_T
    xs_o = torch.stack(xs_out)          # [T+1, ndx, n, B]
    us_o = torch.stack(us_out)          # [T, nu, n, B]
    return tuple(Trial(xs_o[:, :, i].contiguous(), us_o[:, :, i].contiguous(), cost[i])
                 for i in range(n))


def rollout2_plain(spec: VSASpec, xs, us, k, K, x0, alpha_a, alpha_b, wterm, lb, ub,
                   fs=None, infeas=None, tgt=None):
    """Plain PyTorch version of K3: both trials as lanes of shape ``[2, B]``."""
    return _rollout_plain(spec, xs, us, k, K, x0, torch.stack([alpha_a, alpha_b]), wterm,
                          lb, ub, fs, infeas, tgt)


def rollout1_plain(spec: VSASpec, xs, us, k, K, x0, alpha, wterm, lb, ub, fs=None,
                   infeas=None, tgt=None) -> Trial:
    """Plain PyTorch version of K6: K3's plain version with both trials at
    ``alpha``, the first kept. The CPU's elementwise kernels pick a
    vectorized or a scalar loop by tensor size, and libm's and SLEEF's
    last bits differ; at K3's shapes K6's plain version equals K3's first
    trial to the bit, as the kernels do."""
    return _rollout_plain(spec, xs, us, k, K, x0, torch.stack([alpha, alpha]), wterm, lb, ub,
                          fs, infeas, tgt)[0]


def _rollout_instance(spec, lb, fs):
    """The key of ``build.INSTANCES`` for K3 and K6 on these inputs: the box a
    lane's (" box") or the ``[T, nu]`` tables (" box tables")."""
    box = "" if lb is None else " box tables" if spec.per_knot_box else " box"
    return f"nl={spec.nl} {spec.variant}{box}{'' if fs is None else ' gaps'}"


def _rollout_checks(name, spec, xs, us, k, K, x0, alphas, wterm, lb, ub, fs, infeas, tgt):
    _need_table(spec, tgt)
    _build.require(name, _rollout_instance(spec, lb, fs))
    T, NDX, NU, B = us.shape[0], spec.ndx, spec.nu, xs.shape[-1]
    checks = [("xs", xs, (T + 1, NDX, B)), ("us", us, (T, NU, B)),
              ("k", k, (T, NU, B)), ("K", K, (T, NU, NDX, B)),
              ("x0", x0, (NDX, B)), ("wterm", wterm, (B,))]
    checks += [(name, a, (B,)) for name, a in alphas]
    if lb is not None:
        box = (T, NU) if spec.per_knot_box else (NU, B)
        checks += [("lb", lb, box), ("ub", ub, box)]
    if fs is not None:
        checks += [("fs", fs, (T + 1, NDX, B)), ("infeas", infeas, (B,))]
    if tgt is not None:
        checks += [("tgt", tgt, (T, 12))]
    for name, t, shape in checks:
        _check_lane(name, t, shape, xs.dtype, xs.device)


def _pairs(spec, lb, ub, fs, infeas):
    if (lb is None) != (ub is None) or (fs is None) != (infeas is None):
        raise ValueError("lb and ub, and fs and infeas, come in pairs")
    if spec.per_knot_box and lb is None:
        raise ValueError("a per-knot box: pass its [T, nu] tables as lb and ub")


def _rollout_entry(base, spec, tgt):
    """The rollout's C entry: the shared problem's instances, or those that
    take the tables (``csrc/rollout*_tables.cu``)."""
    return base + ("_tables" if tgt is not None or spec.per_knot_box else "")


def _box_ptrs(spec, lb, ub):
    """(lb, ub, lb table, ub table) pointers: a box a lane, or the tables."""
    if spec.per_knot_box:
        return None, None, _opt(lb), _opt(ub)
    return _opt(lb), _opt(ub), None, None


def rollout2(spec: VSASpec, xs, us, k, K, x0, alpha_a, alpha_b, wterm, lb, ub,
             fs=None, infeas=None, tgt=None):
    """K3 on lane tensors ``xs [T+1, ndx, B]``, ``us``/``k [T, nu, B]``,
    ``K [T, nu, ndx, B]``, ``x0 [ndx, B]``, ``alpha_a``/``alpha_b``/``wterm
    [B]``, ``lb``/``ub [nu, B]`` (a box a lane; ``[T, nu]`` tables where
    ``spec.per_knot_box``) or None (no box), for the FDDP gap contraction
    ``fs [T+1, ndx, B]`` and ``infeas [B]`` (1 on an infeasible lane, 0 on a
    feasible one), and the running cost's target table ``tgt [T, 12]``
    (needed for a per-knot target; given for a shared one, it takes the
    table's branch of the kernel); returns the two :class:`Trial`\\ s."""
    _pairs(spec, lb, ub, fs, infeas)
    if _route(xs) == "plain":
        return rollout2_plain(spec, xs, us, k, K, x0, alpha_a, alpha_b, wterm, lb, ub,
                              fs, infeas, tgt)
    _rollout_checks("rollout2", spec, xs, us, k, K, x0,
                    [("alpha_a", alpha_a), ("alpha_b", alpha_b)], wterm, lb, ub, fs, infeas,
                    tgt)
    T, NDX, NU, B = us.shape[0], spec.ndx, spec.nu, xs.shape[-1]
    dt, dev = xs.dtype, xs.device
    outs = [torch.empty(s, dtype=dt, device=dev)
            for _ in range(2) for s in ((T + 1, NDX, B), (T, NU, B), (B,))]
    params, pp = _params_ptr(spec)
    p = _build.ptr
    code = _build.entry(_rollout_entry("aslr_rollout2", spec, tgt), dt, spec.nl)(
        pp, spec.nl, p(xs), p(us), p(k), p(K), p(x0), p(alpha_a), p(alpha_b), p(wterm),
        *_box_ptrs(spec, lb, ub), _opt(fs), _opt(infeas), _opt(tgt), T, B,
        *[p(o) for o in outs], _build.stream_of(xs))
    _build.check("rollout2", code, _rollout_instance(spec, lb, fs))
    return Trial(*outs[:3]), Trial(*outs[3:])


# ---------------------------------------------------------------------------
# K6: one-trial rollout
# ---------------------------------------------------------------------------

def rollout1(spec: VSASpec, xs, us, k, K, x0, alpha, wterm, lb, ub, fs=None,
             infeas=None, tgt=None) -> Trial:
    """K6 on lane tensors: K3's inputs with one step length ``alpha [B]``;
    returns its :class:`Trial`, equal to K3's first trial at ``alpha``."""
    _pairs(spec, lb, ub, fs, infeas)
    if _route(xs) == "plain":
        return rollout1_plain(spec, xs, us, k, K, x0, alpha, wterm, lb, ub, fs, infeas, tgt)
    _rollout_checks("rollout1", spec, xs, us, k, K, x0, [("alpha", alpha)], wterm, lb, ub,
                    fs, infeas, tgt)
    T, NDX, NU, B = us.shape[0], spec.ndx, spec.nu, xs.shape[-1]
    dt, dev = xs.dtype, xs.device
    out = Trial(torch.empty((T + 1, NDX, B), dtype=dt, device=dev),
                torch.empty((T, NU, B), dtype=dt, device=dev),
                torch.empty((B,), dtype=dt, device=dev))
    params, pp = _params_ptr(spec)
    p = _build.ptr
    code = _build.entry(_rollout_entry("aslr_rollout1", spec, tgt), dt, spec.nl)(
        pp, spec.nl, p(xs), p(us), p(k), p(K), p(x0), p(alpha), p(wterm),
        *_box_ptrs(spec, lb, ub), _opt(fs), _opt(infeas), _opt(tgt), T, B,
        *[p(o) for o in out], _build.stream_of(xs))
    _build.check("rollout1", code, _rollout_instance(spec, lb, fs))
    return out


# ---------------------------------------------------------------------------
# the per-scenario solver's fast path
# ---------------------------------------------------------------------------

class FastPath(NamedTuple):
    linearize: object   # (xs [B,T+1,nx], us [B,T,nu], wterm [B]) -> (cost, run, term, xnext, ok)
    rollout: object     # (xs, us, k, K, x0, alpha, fs, infeas, wterm) -> (xs_try, us_try, cost)
    backward: object    # riccati.py::riccati_batch_major with this path's backend
    wterm_of: object    # problem -> its terminal goal weight (a float or a 0-d tensor)


def terminal_weight(problem):
    """The terminal goal weight of ``problem``, read from the problem that
    is solved (a homotopy stage scales it), never from the one a path was
    built for: the sum of the terminal cost items' weights (the kernels
    take goal-only terminal costs)."""
    w = 0.0
    for it in problem.terminal.differential.costs.items:
        w = w + it.weight
    return w


def supports_fast_path(problem, bounds=None):
    """``(ok, reason)``: whether the fused kernels cover this problem; the
    reason names the first unsupported feature."""
    try:
        extract_vsa_spec(problem, bounds)
        return True, ""
    except TypeError as e:
        return False, str(e)


def build_fast_path(problem, bounds, use_gaps: bool = False, backend: str = "auto") -> FastPath:
    """The fused route of ``solvers/ddp.py::solve`` for a concrete problem:
    the linearization through K1, each line-search trial through K6 and the
    backward through the family's Riccati kernel, with the batch-major
    tensors of the solver relayouted to the kernels' lane layout and back
    at each call (as the JAX package's ``custom_vmap`` rules do).
    ``use_gaps`` gives the FDDP gap-contracting rollout. ``backend="plain"``
    takes the kernels' plain versions on any device. A per-knot target
    goes to K1 and K6 as a table, a per-knot box to K6 as tables (the
    backward of a per-knot box is the generic sweep, as in the JAX
    package). Raises ``TypeError`` naming the first feature the kernels do
    not take."""
    from ..models.integrator import ActionDerivs
    from .riccati import riccati_batch_major

    if backend not in ("auto", "plain"):
        raise ValueError(f"backend must be 'auto' or 'plain', got {backend!r}")
    spec = extract_vsa_spec(problem, bounds)
    auto = backend == "auto"
    lin_fn = linearize if auto else linearize_plain
    roll_fn = rollout1 if auto else rollout1_plain
    NDX, NU, T = spec.ndx, spec.nu, problem.T
    tables = {}     # the target and box tables, made once per type and device

    def table(dt, dev):
        key = (dt, dev)
        if key not in tables:
            def t(a):
                return None if a is None else torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                                              device=dev)
            tables[key] = (t(spec.target_table(T, dt) if spec.per_knot_target else None),
                           t(spec.lb if spec.per_knot_box else None),
                           t(spec.ub if spec.per_knot_box else None))
        return tables[key]

    def lin(xs, us, wterm):
        tgt = table(xs.dtype, xs.device)[0]
        out = lin_fn(spec, to_lanes(xs), to_lanes(us), wterm, tgt)
        run = ActionDerivs(**{name: from_lanes(v) for name, v in out.run.items()})
        B = xs.shape[0]

        def z(*shape):
            return torch.zeros((B,) + shape, dtype=xs.dtype, device=xs.device)

        eye = torch.eye(NDX, dtype=xs.dtype, device=xs.device).expand(B, NDX, NDX)
        term = ActionDerivs(Fx=eye, Fu=z(NDX, NU), Lx=from_lanes(out.term["Lx"]), Lu=z(NU),
                            Lxx=from_lanes(out.term["Lxx"]), Lxu=z(NDX, NU), Luu=z(NU, NU))
        return out.cost, run, term, from_lanes(out.xnext), out.ok

    boxes = {}      # the box in lanes, made once per batch, type and device

    def box_lanes(B, dt, dev):
        if spec.per_knot_box:
            return table(dt, dev)[1:]
        if spec.lb is None:
            return None, None
        key = (B, dt, dev)
        if key not in boxes:
            # a copy from the host memory: one host sync, not one a trial
            boxes[key] = tuple(torch.as_tensor(b, dtype=dt, device=dev)[:, None]
                               .expand(NU, B).contiguous() for b in (spec.lb, spec.ub))
        return boxes[key]

    def roll(xs, us, k, K, x0, alpha, fs, infeas, wterm):
        box = box_lanes(xs.shape[0], xs.dtype, xs.device)
        gaps = (to_lanes(fs), infeas.to(xs.dtype)) if use_gaps else (None, None)
        tr = roll_fn(spec, to_lanes(xs), to_lanes(us), to_lanes(k), to_lanes(K), to_lanes(x0),
                     alpha.contiguous(), wterm, *box, *gaps, tgt=table(xs.dtype, xs.device)[0])
        return from_lanes(tr.xs), from_lanes(tr.us), tr.cost

    return FastPath(linearize=lin, rollout=roll,
                    backward=partial(riccati_batch_major, plain=not auto),
                    wterm_of=terminal_weight)
