"""DDP solver family: DDP, FDDP, BoxDDP, BoxFDDP, the generic per-scenario
solver.

PyTorch counterpart of ``aslr_to_tpu/solvers/ddp.py``: the same
Crocoddyl-faithful engine (Levenberg-Marquardt regularization of Quu and
Vxx, the FDDP gap deflection and gap-aware expected improvement, the
BoxQP backward and clamped rollouts, the acceptance and regularization
schedule), written batch-first. ``solve`` takes a batch of scenarios that
share every model leaf except the initial state (``problem.x0 [B, nx]``)
and returns what ``vmap(solve)`` of the JAX package returns, lane by lane:
each of JAX's ``while_loop``\\ s becomes a Python loop that runs while any
lane's condition holds and masks each lane's update with its own
condition (one host read a round). The line search runs one trial a
round with early exit on the fast route; the generic route rolls out
every step length at once (``_all_trials_at_once``), which gives each
lane the same first accepting step length in one launch sequence.

The linearization (``calc_with_diff`` over the knots), the backward
sweep (a loop over the knots, batched over the scenarios) and the
rollout are the reference implementation. ``fast`` (see
``kernels/vsa_kernels.py::build_fast_path``) sends the linearization to
K1 and each trial to K6, and ``settings.use_pallas_backward`` sends the
backward to K2 (shared box, no gaps), K5 (shared box, gaps) or K4 (no
box, gaps) — the JAX package's routing — with a relayout between the
batch-major tensors here and the kernels' lane layout at each call. The
batched lane solver of the same algorithm is ``kernels/lane_solver.py``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .boxqp import boxqp, cho_solve, cholesky_nan, masked_free_solve
from .problem import ShootingProblem


class Bounds(NamedTuple):
    """Control bounds ``lb <= u <= ub``: ``[nu]`` shared by every knot, or
    ``[T, nu]``, row t the box of knot t."""

    lb: torch.Tensor
    ub: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SolverSettings:
    """Crocoddyl-default thresholds; see ``aslr_to_tpu/solvers/ddp.py`` for
    the rationale of each knob."""

    maxiter: int = 100
    th_stop: float = 1e-9        # on sum ||Qu||^2
    th_grad: float = 1e-12
    th_gaptol: float = 1e-9
    th_acceptstep: float = 0.1
    th_acceptnegstep: float = 2.0
    th_stepdec: float = 0.5
    th_stepinc: float = 0.01
    reg_init: float = 1e-9
    reg_min: float = 1e-9
    reg_max: float = 1e9
    reg_factor: float = 10.0
    n_alphas: int = 10
    boxqp_iters: int = 6
    boxqp_alphas: int = 5
    # > 0: warm-start each knot's BoxQP from the previous iteration's du and
    # run this many QP iterations instead of boxqp_iters (0 = off)
    boxqp_warm_iters: int = 0
    # max in-iteration backward retries (reg x reg_factor bumps)
    bw_retry_cap: int = 3
    # early retirement of doomed scenarios (0 = off)
    doomed_reject_iters: int = 0
    # reg factor after a rejection of the whole alpha ladder
    reg_reject_factor: float = 10.0
    # the backward through the Riccati kernels (K2, K4, K5) where the
    # family has one; DDP without box or gaps keeps the generic sweep
    use_pallas_backward: bool = False
    # the log-depth associative backward: not ported yet
    assoc_backward: bool = False


class SolveLog(NamedTuple):
    """Per-iteration series (``[B, maxiter]``, NaN past the last
    iteration; empty ``[B, 0]`` when off)."""

    costs: torch.Tensor
    stops: torch.Tensor
    regs: torch.Tensor
    steps: torch.Tensor
    d1: torch.Tensor
    d2: torch.Tensor
    gap_norms: torch.Tensor


class SolveResult(NamedTuple):
    xs: torch.Tensor           # [B, T+1, nx]
    us: torch.Tensor           # [B, T, nu]
    cost: torch.Tensor         # [B]
    stop: torch.Tensor         # [B]
    iterations: torch.Tensor   # [B] int32
    converged: torch.Tensor    # [B] bool
    diverged: torch.Tensor     # [B] bool
    reg: torch.Tensor          # [B]
    log: SolveLog


class _Backward(NamedTuple):
    k: torch.Tensor          # [B, T, nu]
    K: torch.Tensor          # [B, T, nu, ndx]
    Vx: torch.Tensor         # [B, T+1, ndx]
    w: torch.Tensor          # [B, T+1, ndx] deflections Vxx_t fs_t (dv = -sum w.dx)
    dg: torch.Tensor         # [B] sum Qu.k
    dq: torch.Tensor         # [B] -sum k'Quu k
    dg_gap: torch.Tensor     # [B] -sum Vx.fs
    dq_gap: torch.Tensor     # [B] +sum fs'Vxx fs
    stop: torch.Tensor       # [B] sum ||Qu||^2
    ok: torch.Tensor         # [B] bool
    retryable: torch.Tensor  # [B] bool: a failure with Quu still finite


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _dot(a, b):
    return (a * b).sum(-1)


def _knot_box(bounds, t):
    """(lb, ub) of knot ``t``: the shared ``[nu]`` box or row t of a
    ``[T, nu]`` one."""
    if bounds.lb.dim() == 2:
        return bounds.lb[t], bounds.ub[t]
    return bounds.lb, bounds.ub


def _linearize_core(problem: ShootingProblem, xs, us):
    """calc + calc_diff over every knot at once (a per-knot problem: knot by
    knot, each with its own model), and the terminal knot: (cost [B], run
    ActionDerivs [B, T, ...], term ActionDerivs [B, ...], xnext [B, T, nx],
    ok [B]: every derivative finite)."""
    if problem.per_knot:
        outs = [m.calc_with_diff(xs[:, t], us[:, t])
                for t, m in enumerate(problem.knot_models)]
        run_data, run_diff = (type(group[0])(*(torch.stack(f, dim=1) for f in zip(*group)))
                              for group in zip(*outs))
    else:
        run_data, run_diff = problem.running.calc_with_diff(xs[:, :-1], us)
    u0 = torch.zeros(xs.shape[:1] + (problem.terminal.nu,), dtype=xs.dtype, device=xs.device)
    term_data, term_diff = problem.terminal.calc_with_diff(xs[:, -1], u0)
    cost = run_data.cost.sum(-1) + term_data.cost
    ok = torch.ones_like(cost, dtype=torch.bool)
    for leaf in run_diff + term_diff:
        ok = ok & torch.isfinite(leaf).flatten(1).all(1)
    return cost, run_diff, term_diff, run_data.xnext, ok


def _gaps(problem: ShootingProblem, xs, xnext):
    state = problem.state
    fs0 = state.diff(xs[:, 0], problem.x0)
    return torch.cat([fs0[:, None], state.diff(xs[:, 1:], xnext)], dim=1)


def _backward(problem, run_diff, term_diff, fs, us, reg, use_gaps, bounds, settings,
              kprev=None, fast=None) -> _Backward:
    """Riccati sweep of the family; ``kprev [B, T, nu]`` warm-starts the
    BoxQPs. With ``use_pallas_backward`` the families that have a kernel
    go through it (``fast.backward`` where the fast path is given); a
    per-knot ``[T, nu]`` box runs the generic sweep, as in the JAX package
    (the lane solver takes it to K2 and K5 as a table)."""
    warm = kprev is not None
    qp_iters = settings.boxqp_warm_iters if warm else settings.boxqp_iters
    shared_box = bounds is None or bounds.lb.dim() == 1
    if settings.use_pallas_backward and shared_box and (bounds is not None or use_gaps):
        from ..kernels.riccati import riccati_batch_major

        B, T = us.shape[:2]
        ndx = problem.state.ndx
        riccati = riccati_batch_major if fast is None else fast.backward
        out = riccati(run_diff, term_diff, fs if use_gaps else None, us, kprev, bounds, reg,
                      qp_iters)
        zeros = torch.zeros((B, T + 1, ndx), dtype=us.dtype, device=us.device)
        if not use_gaps:
            zero = torch.zeros_like(out.dg)
            return _Backward(k=out.k, K=out.K, Vx=zeros, w=zeros, dg=out.dg, dq=out.dq,
                             dg_gap=zero, dq_gap=zero, stop=out.stop, ok=out.ok,
                             retryable=out.retryable)
        return _Backward(k=out.k, K=out.K, Vx=zeros, w=out.w, dg=out.dg, dq=out.dq,
                         dg_gap=out.dg_gap, dq_gap=out.dq_gap, stop=out.stop, ok=out.ok,
                         retryable=out.retryable)
    return _backward_scan(problem, run_diff, term_diff, fs, us, reg, use_gaps, bounds,
                          settings, kprev, qp_iters)


def _backward_scan(problem, run_diff, term_diff, fs, us, reg, use_gaps, bounds, settings,
                   kprev, qp_iters) -> _Backward:
    """The generic sweep, batched over the scenarios, one knot at a time
    from the last."""
    ndx, nu = problem.state.ndx, problem.nu
    B, T = us.shape[:2]
    dtype, dev = us.dtype, us.device
    eye_u = torch.eye(nu, dtype=dtype, device=dev)
    eye_x = torch.eye(ndx, dtype=dtype, device=dev)
    reg_m = reg[:, None, None]

    Vxx = term_diff.Lxx + reg_m * eye_x
    # FDDP deflects the value gradient at every node: Vx + Vxx fs
    w_T = _mv(Vxx, fs[:, -1]) if use_gaps else torch.zeros_like(term_diff.Lx)
    Vx_T = term_diff.Lx + w_T if use_gaps else term_diff.Lx
    Vx = Vx_T
    zero_w = torch.zeros_like(Vx)
    outs = [None] * T
    for t in range(T - 1, -1, -1):
        Fx, Fu = run_diff.Fx[:, t], run_diff.Fu[:, t]
        FxT, FuT = Fx.transpose(-1, -2), Fu.transpose(-1, -2)
        Qx = run_diff.Lx[:, t] + _mv(FxT, Vx)
        Qu = run_diff.Lu[:, t] + _mv(FuT, Vx)
        FxTVxx = FxT @ Vxx
        Qxx = run_diff.Lxx[:, t] + FxTVxx @ Fx
        Qxu = run_diff.Lxu[:, t] + FxTVxx @ Fu
        Quu = run_diff.Luu[:, t] + FuT @ Vxx @ Fu + reg_m * eye_u
        if bounds is None:
            L = cholesky_nan(Quu)
            k = cho_solve(L, Qu)
            K = cho_solve(L, Qxu.transpose(-1, -2))
            ok = torch.isfinite(L).flatten(1).all(1)
        else:
            u_t = us[:, t]
            lb, ub = _knot_box(bounds, t)
            x0 = torch.zeros_like(u_t) if kprev is None else -kprev[:, t]
            qp = boxqp(Quu, Qu, lb - u_t, ub - u_t, x0, maxiter=qp_iters,
                       n_alphas=settings.boxqp_alphas)
            k = -qp.x
            K = masked_free_solve(Quu, qp.free, Qxu.transpose(-1, -2))
            ok = torch.isfinite(k).all(1) & torch.isfinite(K).flatten(1).all(1)
        Quuk = _mv(Quu, k)
        KT = K.transpose(-1, -2)
        Vx = Qx + _mv(KT, Quuk) - 2.0 * _mv(KT, Qu)
        Vxx = Qxx - Qxu @ K
        Vxx = 0.5 * (Vxx + Vxx.transpose(-1, -2)) + reg_m * eye_x
        if use_gaps:
            w = _mv(Vxx, fs[:, t])
            Vx = Vx + w
        else:
            w = zero_w
        out_ok = (torch.isfinite(k).all(1) & torch.isfinite(K).flatten(1).all(1)
                  & torch.isfinite(Vx).all(1) & torch.isfinite(Vxx).flatten(1).all(1))
        indef = torch.isfinite(Quu).flatten(1).all(1) & ~out_ok
        outs[t] = (k, K, Vx, w, _dot(Qu, k), -_dot(k, Quuk), _dot(Qu, Qu), ok, indef)

    k, K, Vx_t, w_t, dg_t, dq_t, stop_t, ok_t, indef_t = (
        torch.stack(o, dim=1) for o in zip(*outs))
    Vx_all = torch.cat([Vx_t, Vx_T[:, None]], dim=1)
    w_all = torch.cat([w_t, w_T[:, None]], dim=1)
    if use_gaps:
        dg_gap = -torch.einsum("bti,bti->b", Vx_all, fs)
        dq_gap = torch.einsum("bti,bti->b", fs, w_all)
    else:
        dg_gap = dq_gap = torch.zeros((B,), dtype=dtype, device=dev)
    return _Backward(k=k, K=K, Vx=Vx_all, w=w_all, dg=dg_t.sum(1), dq=dq_t.sum(1),
                     dg_gap=dg_gap, dq_gap=dq_gap, stop=stop_t.sum(1), ok=ok_t.all(1),
                     retryable=indef_t.any(1))


def _rollout(problem, xs, us, k, K, fs, alpha, gap_scale_on, use_gaps, bounds):
    """One trial at the step lengths ``alpha [B]``: FDDP contracts the gaps
    by (1 - alpha) on the lanes with ``gap_scale_on``; DDP rolls out from
    x0. The Box variants clamp the controls (a per-knot box: knot t to row
    t). Returns (xs_try, us_try, cost_try)."""
    state = problem.state
    T = us.shape[1]
    gscale = torch.where(gap_scale_on, alpha - 1.0, 0.0)[:, None] if use_gaps else None
    x = state.integrate(problem.x0, fs[:, 0] * gscale) if use_gaps else problem.x0
    cost = torch.zeros_like(alpha)
    xs_out, us_out = [], []
    for t in range(T):
        dx = state.diff(xs[:, t], x)
        u = us[:, t] - alpha[:, None] * k[:, t] - _mv(K[:, t], dx)
        if bounds is not None:
            lb, ub = _knot_box(bounds, t)
            u = torch.minimum(torch.maximum(u, lb), ub)
        data = problem.knot_model(t).calc(x, u)
        xs_out.append(x)
        us_out.append(u)
        cost = cost + data.cost
        x = state.integrate(data.xnext, fs[:, t + 1] * gscale) if use_gaps else data.xnext
    u0 = torch.zeros(x.shape[:1] + (problem.terminal.nu,), dtype=x.dtype, device=x.device)
    cost = cost + problem.terminal.calc(x, u0).cost
    return torch.stack(xs_out + [x], dim=1), torch.stack(us_out, dim=1), cost


def solve(problem: ShootingProblem, xs_init=None, us_init=None,
          settings: SolverSettings = SolverSettings(), use_gaps: bool = True,
          bounds: Optional[Bounds] = None, fast=None) -> SolveResult:
    """Solve the scenarios of ``problem`` (``x0 [B, nx]``), from ``xs_init
    [B, T+1, nx]`` and ``us_init [B, T, nu]`` (default: x0 everywhere and
    zero controls). ``use_gaps`` selects the FDDP family, ``bounds`` the
    Box variants; ``fast`` the fused kernels (``build_fast_path``). A
    per-knot problem (``problem.per_knot``) and a ``[T, nu]`` box run knot
    by knot.

    The float32 products run in full float32 (no TF32), as the JAX package
    pins them: reduced-precision passes doubled the f32 divergence there.
    """
    if settings.assoc_backward:
        raise NotImplementedError("assoc_backward (solvers/assoc_riccati.py) is not ported yet")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _solve_impl(problem, xs_init, us_init, settings, use_gaps, bounds, fast)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def accept_trial(s: SolverSettings, use_gaps, alpha, d1, d2, dV, finite, feasible):
    """Crocoddyl's acceptance test of a trial at step lengths ``alpha``
    (per lane), given the expected-improvement terms ``d1``, ``d2`` (with
    the FDDP dv correction already in) and the cost decrease ``dV``."""
    dVexp = alpha * (d1 + 0.5 * alpha * d2)
    if use_gaps:
        accept_pos = (dVexp >= 0.0) & ((d1 < s.th_grad) | (dV > s.th_acceptstep * dVexp))
        accept_neg = (dVexp < 0.0) & (dV > s.th_acceptnegstep * dVexp)
        return finite & (accept_pos | accept_neg)
    return finite & (dVexp >= 0.0) & (
        (d1 < s.th_grad) | (~feasible) | (dV > s.th_acceptstep * dVexp))


class Schedule(NamedTuple):
    reg: torch.Tensor
    diverged: torch.Tensor
    converged: torch.Tensor
    done: torch.Tensor
    rej_streak: torch.Tensor
    nrt_streak: torch.Tensor


def schedule(s: SolverSettings, any_accept, alpha_b, alpha_last, reg_bw, bw_ok, bw_retryable,
             lin_ok, feasible, stop, it1, rej_streak, nrt_streak) -> Schedule:
    """The regularization schedule and the termination flags of one pass,
    per lane: step-based reg increase/decrease (x reg_reject_factor after
    a rejection of the whole ladder), divergence at reg_max or on a
    non-finite linearization, doomed-lane retirement when on, convergence
    on a feasible lane with stop < th_stop."""
    eff_step = torch.where(any_accept, alpha_b, alpha_last)
    reg_dec = torch.clamp(reg_bw / s.reg_factor, min=s.reg_min)
    inc_f = torch.where(any_accept, s.reg_factor, s.reg_reject_factor).to(reg_bw.dtype)
    reg_inc = torch.clamp(reg_bw * inc_f, max=s.reg_max)
    do_inc = eff_step <= s.th_stepinc
    do_dec = (~do_inc) & (eff_step > s.th_stepdec)
    reg_new = torch.where(do_inc, reg_inc, torch.where(do_dec, reg_dec, reg_bw))
    bw_failed = ~bw_ok
    div_now = ((bw_failed & (reg_bw >= s.reg_max))
               | (do_inc & (reg_new >= s.reg_max)) | ~lin_ok)
    full_reject = (~any_accept) & do_inc
    rej_new = torch.where(full_reject, rej_streak + 1, torch.zeros_like(rej_streak))
    nonretry = bw_failed & ~bw_retryable
    nrt_new = torch.where(nonretry, nrt_streak + 1, torch.zeros_like(nrt_streak))
    if s.doomed_reject_iters:
        div_now = div_now | (rej_new >= s.doomed_reject_iters) | (nrt_new >= 2)
    conv_now = feasible & (stop < s.th_stop)
    done_now = conv_now | div_now | (it1 >= s.maxiter)
    return Schedule(reg_new, div_now, conv_now, done_now, rej_new, nrt_new)


def log_set(series, it, value, active):
    """series[b, it[b]] = value[b] on the active lanes (no host read)."""
    idx = it.clamp(max=series.shape[1] - 1).long()[:, None]
    old = series.gather(1, idx)[:, 0]
    return series.scatter(1, idx, torch.where(active, value, old)[:, None])


def _all_trials_at_once(fast) -> bool:
    """Whether the line search rolls out every step length in one batched
    rollout instead of one trial a round with early exit. Both give each
    lane its first accepting step length (to the bit on the CPU; on the
    card a batch of another size may round a trial otherwise). The generic
    route takes the batch: a round costs the launches of its T knots'
    models (about 1,000 small torch calls a knot) more than their
    arithmetic, so on an H100 the batch ran the double pendulum 5.8-6.0x
    and a 2-DoF BoxDDP 4.7x faster, and on the CPU (4 threads) the
    pendulum 1.8-3.0x and the BoxDDP 2.2x faster, and a 2-DoF SEA FDDP,
    which mostly takes the full step, 7-13% slower (``line_search_ab.py``).
    The fast route keeps one K6 launch a round, as before: there the batch
    took 25-26% less time on the 2-DoF BoxDDP and 2-8% more on the SEA
    FDDP on the H100 (on the CPU 3.5-4.1x less and 9-12% more)."""
    return fast is None


def _solve_impl(problem, xs_init, us_init, s, use_gaps, bounds, fast):
    T, nu = problem.T, problem.nu
    x0 = problem.x0
    B, dtype, dev = x0.shape[0], x0.dtype, x0.device
    xs = (x0[:, None].expand(B, T + 1, x0.shape[1]).clone() if xs_init is None
          else xs_init.to(dtype))
    us = torch.zeros((B, T, nu), dtype=dtype, device=dev) if us_init is None else us_init.to(dtype)
    if bounds is not None:
        # project the warm start into the box (a bound-violating guess
        # makes the expected-improvement model point outward)
        us = torch.minimum(torch.maximum(us, bounds.lb), bounds.ub)

    alphas = torch.tensor([2.0 ** -i for i in range(s.n_alphas)], dtype=dtype, device=dev)
    log = SolveLog(*[torch.full((B, s.maxiter), float("nan"), dtype=dtype, device=dev)
                     for _ in SolveLog._fields])
    cost = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    stop = cost.clone()
    reg = torch.full((B,), s.reg_init, dtype=dtype, device=dev)
    it = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    converged = torch.zeros_like(done)
    diverged = torch.zeros_like(done)
    kprev = torch.zeros((B, T, nu), dtype=dtype, device=dev)
    rej_streak = torch.zeros_like(it)
    nrt_streak = torch.zeros_like(it)
    warm = s.boxqp_warm_iters > 0 and bounds is not None
    wterm = None
    if fast is not None:
        # the weight of the problem solved here (a homotopy stage's), not
        # the one the path was built for
        w = fast.wterm_of(problem)
        wterm = (w.to(dtype=dtype, device=dev).expand(B).contiguous()
                 if isinstance(w, torch.Tensor)
                 else torch.full((B,), w, dtype=dtype, device=dev))

    while bool((~done).any()):
        active = ~done
        if fast is not None:
            cost_lin, run_diff, term_diff, xnext, lin_ok = fast.linearize(xs, us, wterm)
        else:
            cost_lin, run_diff, term_diff, xnext, lin_ok = _linearize_core(problem, xs, us)
        fs = _gaps(problem, xs, xnext)
        gap_norm = fs.abs().flatten(1).amax(1)
        feasible = gap_norm < s.th_gaptol
        infeasible_f = (~feasible).to(dtype)
        # a non-finite linearization can never give a backward pass
        lin_ok = lin_ok & torch.isfinite(cost_lin)

        # -- backward pass with the per-lane regularization retry ---------
        kp = kprev if warm else None

        def backward(r):
            return _backward(problem, run_diff, term_diff, fs, us, r, use_gaps, bounds, s,
                             kp, fast)

        reg_bw = reg
        bw = backward(reg_bw)
        tries = torch.zeros_like(it)
        while True:
            pred = ((~bw.ok) & bw.retryable & (reg_bw < s.reg_max)
                    & (tries < s.bw_retry_cap) & active & lin_ok)
            if not bool(pred.any()):
                break
            reg_bw = torch.where(pred, torch.clamp(reg_bw * s.reg_factor, max=s.reg_max), reg_bw)
            bw2 = backward(reg_bw)
            bw = _Backward(*(torch.where(pred.view((-1,) + (1,) * (n.dim() - 1)), n, o)
                             for n, o in zip(bw2, bw)))
            tries = tries + pred.to(tries.dtype)
        bw_failed = ~bw.ok

        # -- expected improvement model (gap-aware for FDDP) ---------------
        if use_gaps:
            dg = bw.dg + infeasible_f * bw.dg_gap
            dq = bw.dq + infeasible_f * bw.dq_gap
        else:
            dg, dq = bw.dg, bw.dq

        def try_alpha(alpha, n=1):
            """Trials at the step lengths ``alpha [n B]``: n copies of the
            batch, copy j at its lanes' alpha[j B: (j + 1) B]."""
            def rep(t):
                return t.repeat((n,) + (1,) * (t.dim() - 1)) if n > 1 else t

            xs_n, infeas_n = rep(xs), rep(infeasible_f)
            if fast is not None:
                xs_t, us_t, cost_t = fast.rollout(xs_n, rep(us), rep(bw.k), rep(bw.K),
                                                  rep(problem.x0), alpha, rep(fs),
                                                  rep(~feasible), rep(wterm))
            else:
                p_n = problem if n == 1 else dataclasses.replace(problem, x0=rep(problem.x0))
                xs_t, us_t, cost_t = _rollout(p_n, xs_n, rep(us), rep(bw.k), rep(bw.K), rep(fs),
                                              alpha, rep(~feasible), use_gaps, bounds)
            if use_gaps:
                # dv = -sum_t w_t . dx_t, dx = xs (-) xs_try
                dx = problem.state.diff(xs_t, xs_n)
                dv = -torch.einsum("bti,bti->b", rep(bw.w), dx) * infeas_n
                d1 = rep(dg) + dv
                d2 = rep(dq) - 2.0 * dv
            else:
                d1, d2 = rep(dg), rep(dq)
            finite = torch.isfinite(cost_t) & torch.isfinite(xs_t).flatten(1).all(1)
            accept = accept_trial(s, use_gaps, alpha, d1, d2, rep(cost_lin) - cost_t, finite,
                                  rep(feasible))
            return accept, xs_t, us_t, cost_t

        # -- backtracking line search: a lane takes its first accepting
        # step length; finished lanes and failed backwards start "accepted"
        accepted = done | bw_failed
        xs_b, us_b, cost_b = xs, us, cost_lin
        alpha_b = torch.zeros_like(cost_lin)
        if _all_trials_at_once(fast):
            # every step length in one batched rollout (copies of the batch):
            # the rounds' result lane for lane, in one launch sequence
            n = s.n_alphas
            accept, xs_t, us_t, cost_t = try_alpha(alphas.repeat_interleave(B), n)
            hit = accept.view(n, B) & ~accepted
            take = hit.any(0)
            first = hit.to(torch.int32).argmax(0)
            pick = first * B + torch.arange(B, device=dev)
            xs_b = torch.where(take[:, None, None], xs_t[pick], xs_b)
            us_b = torch.where(take[:, None, None], us_t[pick], us_b)
            cost_b = torch.where(take, cost_t[pick], cost_b)
            alpha_b = torch.where(take, alphas[first], alpha_b)
            accepted = accepted | take
        else:
            # early exit, one trial a round
            i = torch.zeros_like(it)
            while True:
                pred = (~accepted) & (i < s.n_alphas)
                if not bool(pred.any()):
                    break
                alpha = alphas[i.clamp(max=s.n_alphas - 1).long()]
                accept, xs_t, us_t, cost_t = try_alpha(alpha)
                take = accept & pred
                i = i + pred.to(i.dtype)
                accepted = accepted | take
                xs_b = torch.where(take[:, None, None], xs_t, xs_b)
                us_b = torch.where(take[:, None, None], us_t, us_b)
                cost_b = torch.where(take, cost_t, cost_b)
                alpha_b = torch.where(take, alpha, alpha_b)
        any_accept = accepted

        # -- regularization schedule / termination -------------------------
        it1 = it + 1
        sched = schedule(s, any_accept, alpha_b, alphas[-1], reg_bw, bw.ok, bw.retryable,
                         lin_ok, feasible, bw.stop, it1, rej_streak, nrt_streak)

        log = SolveLog(*(log_set(series, it, value, active) for series, value in zip(
            log, (cost_b, bw.stop, sched.reg, torch.where(any_accept, alpha_b, 0.0), dg, dq,
                  gap_norm))))
        # masked merge: finished lanes keep their state (vmap semantics)
        act3 = active[:, None, None]
        xs = torch.where(act3, xs_b, xs)
        us = torch.where(act3, us_b, us)
        cost = torch.where(active, cost_b, cost)
        stop = torch.where(active, bw.stop, stop)
        reg = torch.where(active, sched.reg, reg)
        it = torch.where(active, it1, it)
        converged = torch.where(active, sched.converged, converged)
        diverged = torch.where(active, sched.diverged, diverged)
        kprev = torch.where((active & bw.ok)[:, None, None], bw.k, kprev)
        rej_streak = torch.where(active, sched.rej_streak, rej_streak)
        nrt_streak = torch.where(active, sched.nrt_streak, nrt_streak)
        done = torch.where(active, sched.done, done)

    return SolveResult(xs=xs, us=us, cost=cost, stop=stop, iterations=it,
                       converged=converged, diverged=diverged, reg=reg, log=log)


# ---------------------------------------------------------------------------
# Crocoddyl-shaped convenience wrappers
# ---------------------------------------------------------------------------

class _SolverBase:
    """Thin facade over ``solve`` for one scenario (API parity with the
    reference's ``crocoddyl.Solver*`` usage): ``problem.x0`` is ``[nx]``
    and the result is the scenario's, without the batch axis."""

    _use_gaps = True
    _boxed = False

    def __init__(self, problem: ShootingProblem, bounds: Optional[Bounds] = None):
        self.problem = problem
        self.bounds = bounds
        self.th_stop = 1e-9
        if self._boxed and bounds is None:
            raise ValueError("Box solvers need control bounds")

    def solve(self, xs_init=None, us_init=None, maxiter=100,
              settings: Optional[SolverSettings] = None) -> SolveResult:
        p = self.problem
        if settings is None:
            settings = SolverSettings(maxiter=maxiter, th_stop=self.th_stop)

        def batch(a):
            return None if a is None or len(a) == 0 else torch.as_tensor(
                a, dtype=p.x0.dtype, device=p.x0.device)[None]

        res = solve(dataclasses.replace(p, x0=p.x0[None]), batch(xs_init), batch(us_init),
                    settings=settings, use_gaps=self._use_gaps,
                    bounds=self.bounds if self._boxed else None)
        self.result = SolveResult(*[f[0] for f in res[:-1]], SolveLog(*[f[0] for f in res.log]))
        return self.result


class SolverDDP(_SolverBase):
    _use_gaps = False


class SolverFDDP(_SolverBase):
    _use_gaps = True


class SolverBoxDDP(_SolverBase):
    _use_gaps = False
    _boxed = True


class SolverBoxFDDP(_SolverBase):
    _use_gaps = True
    _boxed = True
