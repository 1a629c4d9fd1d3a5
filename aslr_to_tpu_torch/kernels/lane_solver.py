"""Batched DDP / FDDP / BoxDDP / BoxFDDP solver loop in lane layout.

PyTorch counterpart of ``aslr_to_tpu/pallas/lane_solver.py::
build_lane_solver``: a shared model, or a per-knot one whose frame target
varies (K1 and K3 read its ``[T, 12]`` target table), with a shared
``[nu]`` control box, a per-knot ``[T, nu]`` one (K2, K3 and K5 read its
tables) or none. The loop state lives in lane layout (batch innermost: xs
``[T+1, ndx, B]``, us ``[T, nu, B]``) and each iteration runs three kernels:
the linearization (K1), a backward sweep (relaunched by the per-lane
regularization retry) and the two-trial rollout (K3, once per pair of step
lengths). The backward is the family's:

  - BoxDDP (bounds, no gaps): the Box Riccati sweep with BoxQP (K2);
  - FDDP (gaps, no bounds): the gap-aware sweep with Cholesky gains (K4),
    the dv-corrected expected improvement and gap-contracting rollouts;
  - DDP (no gaps, no bounds): K4 with zero gaps;
  - BoxFDDP (gaps and bounds): K4's recursion with K2's masked BoxQP gains
    (K5) and clamped gap-contracting rollouts.

The three nested ``jax.lax.while_loop``\\ s become one batch-first Python
loop with explicit per-lane masks. JAX batches a ``while_loop`` by running
the body while ANY lane's condition holds and masking each lane's update
with its own condition; the loops below do the same with ``torch.where``
on ``[B]`` masks, so a lane reproduces ``vmap(solve)`` of the JAX package.
Each loop condition is a host read (``bool(mask.any())``): that sync is
the accepted cost of this first version; device-side loop control comes
later.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from ..solvers.ddp import (
    Bounds,
    SolveLog,
    SolveResult,
    SolverSettings,
    accept_trial,
    log_set,
    schedule,
)
from ..solvers.problem import ShootingProblem
from . import build as _build
from .riccati import (
    riccati_box_backward,
    riccati_box_plain,
    riccati_boxfddp_backward,
    riccati_boxfddp_plain,
    riccati_fddp_backward,
    riccati_fddp_plain,
)
from .vsa_kernels import (
    extract_vsa_spec,
    linearize,
    linearize_plain,
    rollout2,
    rollout2_plain,
    to_lanes,
)


def _sel(pred, new, old):
    """Per-lane select: pred [B] broadcast against [..., B] tensors."""
    return torch.where(pred, new, old)


def check_device(dev, **tensors):
    """Raise unless every tensor given (None skipped) lies on ``dev``, the
    problem's device: a solve never moves its inputs to another device."""
    for name, x in tensors.items():
        if x is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the problem on {dev}: "
                             "build the problem on the device of the solve")


def build_lane_solver(
    problem: ShootingProblem,
    settings: SolverSettings = SolverSettings(),
    bounds: Optional[Bounds] = None,
    use_gaps: bool = False,
    keep_log: bool = False,
    ls_trials: int = 2,
    backend: str = "auto",
):
    """Build ``solve_batch(x0s[, xs_init, us_init]) -> SolveResult`` for a
    concrete problem; ``x0s`` is ``[B, nx]``. ``use_gaps`` selects the FDDP
    family and ``bounds`` the box variants, as in the JAX package. The
    solve runs on the device of ``problem.x0``.

    ``backend="auto"`` sends CUDA tensors through the kernels and CPU
    tensors through their plain versions; ``backend="plain"`` runs the
    plain versions on any device (the card-side reference of the kernels).

    ``solve_batch`` also takes the homotopy's stage inputs:
    ``wterm_scale`` scales the terminal goal weight (cast to the solve's
    dtype first), and ``box_ub`` (``[nu]``) overrides a shared box's upper
    bound, the warm start projected into that effective box. ``keep_log``
    records the ``SolveLog`` series (``[B, maxiter]``, NaN past a lane's
    last iteration; a lane's row i is written only while it is active).
    """
    if ls_trials != 2:
        raise NotImplementedError("the rollout kernel evaluates two trials per launch")
    if settings.boxqp_alphas != 5:
        raise NotImplementedError("the BoxQP kernels run a 5-step Armijo search")
    if backend not in ("auto", "plain"):
        raise ValueError(f"backend must be 'auto' or 'plain', got {backend!r}")
    s = settings
    spec = extract_vsa_spec(problem, bounds)
    T, nu, NDX = problem.T, spec.nu, spec.ndx
    boxed = bounds is not None
    box_pk = spec.per_knot_box
    auto = backend == "auto"
    lin_fn = linearize if auto else linearize_plain
    roll_fn = rollout2 if auto else rollout2_plain
    if boxed and use_gaps:
        bwd_fn = riccati_boxfddp_backward if auto else riccati_boxfddp_plain
    elif boxed:
        bwd_fn = riccati_box_backward if auto else riccati_box_plain
    else:
        bwd_fn = riccati_fddp_backward if auto else riccati_fddp_plain
    warm = boxed and s.boxqp_warm_iters > 0
    qp_iters = s.boxqp_warm_iters if warm else s.boxqp_iters
    dev = problem.x0.device

    def solve_batch(x0s, xs_init=None, us_init=None, wterm_scale=None, box_ub=None):
        if box_pk and box_ub is not None:
            raise ValueError("box_ub continuation requires a shared "
                             "(non-per-knot) control box")
        if box_ub is not None and not boxed:
            raise ValueError("box_ub requires bounds")
        check_device(dev, x0s=x0s, xs_init=xs_init, us_init=us_init)
        B = x0s.shape[0]
        dtype = x0s.dtype

        x0_l = to_lanes(x0s)                                        # [ndx, B]
        xs = (x0_l.expand(T + 1, NDX, B).contiguous() if xs_init is None
              else to_lanes(xs_init.to(dtype)))
        us = (torch.zeros((T, nu, B), dtype=dtype, device=dev) if us_init is None
              else to_lanes(us_init.to(dtype)))
        lb = ub = None
        if box_pk:
            # the [T, nu] tables, which K2, K3 and K5 read row by row
            lb, ub = (torch.as_tensor(b, dtype=dtype, device=dev) for b in (spec.lb, spec.ub))
            # project the warm start into the box (solvers/ddp.py::_solve_impl)
            us = torch.minimum(torch.maximum(us, lb[:, :, None]), ub[:, :, None])
        elif boxed:
            # box_ub, the stage's upper bound, overrides the shared one
            lb = torch.as_tensor(spec.lb, dtype=dtype, device=dev)[:, None].expand(nu, B)
            ub = torch.as_tensor(spec.ub if box_ub is None else box_ub, dtype=dtype,
                                 device=dev)[:, None].expand(nu, B)
            lb, ub = lb.contiguous(), ub.contiguous()
            us = torch.minimum(torch.maximum(us, lb), ub)
        tgt = (torch.as_tensor(spec.target_table(T, dtype), device=dev)
               if spec.per_knot_target else None)
        zeros_fs = (None if use_gaps or boxed
                    else torch.zeros((T + 1, NDX, B), dtype=dtype, device=dev))
        wterm = torch.full((B,), spec.w_goal_term, dtype=dtype, device=dev)
        if wterm_scale is not None:
            # a 0-d tensor keeps its device: no copy from the host a stage
            wterm = wterm * torch.as_tensor(wterm_scale, dtype=dtype)
        log = SolveLog(*[torch.full((B, s.maxiter if keep_log else 0), float("nan"),
                                    dtype=dtype, device=dev) for _ in SolveLog._fields])
        alphas = torch.tensor([2.0 ** -i for i in range(s.n_alphas)], dtype=dtype, device=dev)

        cost = torch.full((B,), float("inf"), dtype=dtype, device=dev)
        stop = cost.clone()
        reg = torch.full((B,), s.reg_init, dtype=dtype, device=dev)
        it = torch.zeros((B,), dtype=torch.int32, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        converged = torch.zeros_like(done)
        diverged = torch.zeros_like(done)
        kprev = torch.zeros((T, nu, B), dtype=dtype, device=dev)
        rej_streak = torch.zeros_like(it)
        nrt_streak = torch.zeros_like(it)

        while bool((~done).any()):
            active = ~done
            lin = lin_fn(spec, xs, us, wterm, tgt)
            run, term = lin.run, lin.term
            # defect gaps fs = diff(xs, [x0; xnext]); the FDDP family uses
            # them all, the others only the feasibility flag
            fs = torch.cat([(x0_l - xs[0])[None], lin.xnext - xs[1:]], dim=0)
            gap_norm = fs.abs().amax(dim=(0, 1))
            feasible = gap_norm < s.th_gaptol
            infeas = (~feasible).to(dtype)
            lin_ok = torch.isfinite(lin.cost) & lin.ok
            kp = kprev if warm else None
            derivs = (run["Fx"], run["Fu"], run["Lx"], run["Lu"], run["Lxx"], run["Lxu"],
                      run["Luu"], term["Lx"], term["Lxx"])

            def backward(r):
                if boxed and use_gaps:
                    return bwd_fn(*derivs, fs, us, kp, lb, ub, r, qp_iters, box_pk)
                if boxed:
                    return bwd_fn(*derivs, us, kp, lb, ub, r, qp_iters, box_pk)
                return bwd_fn(*derivs, fs if use_gaps else zeros_fs, r)

            # -- backward pass with per-lane regularization retry ----------
            reg_bw = reg
            bw = backward(reg_bw)
            tries = torch.zeros_like(it)
            while True:
                pred = ((~bw.ok) & bw.retryable & (reg_bw < s.reg_max)
                        & (tries < s.bw_retry_cap) & active & lin_ok)
                if not bool(pred.any()):
                    break
                reg_bw = torch.where(pred, torch.clamp(reg_bw * s.reg_factor, max=s.reg_max),
                                     reg_bw)
                bw2 = backward(reg_bw)
                bw = type(bw)(*(_sel(pred, n, o) for n, o in zip(bw2, bw)))
                tries = tries + pred.to(tries.dtype)
            bw_failed = ~bw.ok

            # -- expected improvement model (gap-aware for FDDP) ------------
            if use_gaps:
                dg = bw.dg + infeas * bw.dg_gap
                dq = bw.dq + infeas * bw.dq_gap
            else:
                dg, dq = bw.dg, bw.dq

            # -- early-exit backtracking line search, two trials a launch ---
            def ls_accept(alpha, trial):
                finite = torch.isfinite(trial.cost) & torch.isfinite(trial.xs).all(0).all(0)
                d1, d2 = dg, dq
                if use_gaps:
                    # dv correction (Crocoddyl FDDP::expectedImprovement):
                    # dv = -sum_t w_t . dx_t with dx = xs - xs_try
                    dx = xs - trial.xs
                    dv = -(bw.w * dx).sum(dim=(0, 1)) * infeas
                    d1 = dg + dv
                    d2 = dq - 2.0 * dv
                return accept_trial(s, use_gaps, alpha, d1, d2, lin.cost - trial.cost, finite,
                                    feasible)

            gap_args = (fs, infeas) if use_gaps else (None, None)
            i = torch.zeros_like(it)
            accepted = done | bw_failed
            xs_b, us_b, cost_b = xs, us, lin.cost
            alpha_b = torch.zeros_like(lin.cost)
            while True:
                pred = (~accepted) & (i < s.n_alphas)
                if not bool(pred.any()):
                    break
                a0 = alphas[torch.clamp(i, 0, s.n_alphas - 1).long()]
                a1 = alphas[torch.clamp(i + 1, 0, s.n_alphas - 1).long()]
                tr0, tr1 = roll_fn(spec, xs, us, bw.k, bw.K, x0_l, a0, a1, wterm, lb, ub,
                                   *gap_args, tgt)
                acc0 = ls_accept(a0, tr0)
                # trial 1 counts only for a genuinely new alpha (dedupe at the
                # ladder's end keeps iteration counts equal to one trial a round)
                acc1 = ls_accept(a1, tr1) & (i + 1 < s.n_alphas)
                take = (acc0 | acc1) & pred
                # the first accepting trial wins
                xs_t = _sel(acc0, tr0.xs, tr1.xs)
                us_t = _sel(acc0, tr0.us, tr1.us)
                cost_t = torch.where(acc0, tr0.cost, tr1.cost)
                alpha_t = torch.where(acc0, a0, a1)
                i = i + 2 * pred.to(i.dtype)
                accepted = accepted | take
                xs_b = _sel(take, xs_t, xs_b)
                us_b = _sel(take, us_t, us_b)
                cost_b = torch.where(take, cost_t, cost_b)
                alpha_b = torch.where(take, alpha_t, alpha_b)
            any_accept = accepted

            # -- regularization schedule / termination ---------------------
            it1 = it + 1
            sched = schedule(s, any_accept, alpha_b, alphas[-1], reg_bw, bw.ok, bw.retryable,
                             lin_ok, feasible, bw.stop, it1, rej_streak, nrt_streak)

            if keep_log:
                log = SolveLog(*(log_set(series, it, value, active) for series, value in zip(
                    log, (cost_b, bw.stop, sched.reg, torch.where(any_accept, alpha_b, 0.0),
                          dg, dq, gap_norm))))
            # masked merge: finished lanes keep their state (vmap semantics)
            xs = _sel(active, xs_b, xs)
            us = _sel(active, us_b, us)
            cost = torch.where(active, cost_b, cost)
            stop = torch.where(active, bw.stop, stop)
            reg = torch.where(active, sched.reg, reg)
            it = torch.where(active, it1, it)
            converged = torch.where(active, sched.converged, converged)
            diverged = torch.where(active, sched.diverged, diverged)
            if warm:
                kprev = _sel(active & bw.ok, bw.k, kprev)
            rej_streak = torch.where(active, sched.rej_streak, rej_streak)
            nrt_streak = torch.where(active, sched.nrt_streak, nrt_streak)
            done = torch.where(active, sched.done, done)

        return SolveResult(
            xs=xs.permute(2, 0, 1), us=us.permute(2, 0, 1), cost=cost, stop=stop,
            iterations=it, converged=converged, diverged=diverged, reg=reg, log=log)

    return solve_batch


def build_lane_homotopy(
    problem: ShootingProblem,
    settings: SolverSettings = SolverSettings(),
    bounds: Optional[Bounds] = None,
    use_gaps: bool = False,
    scales=None,
    ub_stages=None,
    keep_log: bool = False,
    rescue_scales=None,
    rescue_ub_stages=None,
    rescue_size: int = 0,
    backend: str = "auto",
):
    """The terminal-weight continuation on the lane route
    (``solvers/homotopy.py::homotopy_solve`` semantics): each stage runs the
    lane solver at a scaled terminal goal weight (``wterm_scale``) and, with
    ``ub_stages [n_stages, nu]``, a stage's control upper bound
    (``box_ub``), warm-started from the last stage; ``settings.maxiter`` is
    a stage's budget. Returns ``solve_batch(x0s[, xs_init, us_init])``.

    ``rescue_size`` > 0 adds the diverged-lane rescue: ``R = min(rescue_size,
    B)`` lanes, the diverged ones first (a stable sort, so the pick is
    the JAX package's), are solved again cold under ``rescue_scales`` /
    ``rescue_ub_stages`` (``rescue_continuation``) and a lane is taken
    from the rescue only where the main pass diverged and the rescue did
    not. Lanes the main pass solved keep its result to the bit.

    ``solve_batch.stats`` holds the last call's host seconds of the main
    pass and of the rescue (each lane loop ends in a host read, so they end
    with the card's work), the counts of lanes the main pass left diverged
    and of lanes rescued (tensors) and, after each stage, ``("main" or
    "rescue", stage, build.LAUNCHES)`` (the kernels' launch counts so far,
    a copy)."""
    from ..solvers.homotopy import DEFAULT_SCALES, stage_arrays

    if scales is None:
        scales = DEFAULT_SCALES
    if ub_stages is not None and bounds is None:
        raise ValueError("ub_stages requires bounds")
    if rescue_size and rescue_scales is None:
        raise ValueError("rescue_size needs rescue_scales")
    lane = build_lane_solver(problem, settings, bounds, use_gaps=use_gaps, keep_log=keep_log,
                             backend=backend)
    dev = problem.x0.device

    def staged(x0s, xs, us, sc, ub, part):
        scale_arr, ub_arr = stage_arrays(sc, ub, x0s.dtype, dev)
        for i in range(scale_arr.shape[0]):
            res = lane(x0s, xs, us, wterm_scale=scale_arr[i],
                       box_ub=None if ub_arr is None else ub_arr[i])
            xs, us = res.xs, res.us
            solve_batch.stats["launches"].append((part, i, dict(_build.LAUNCHES)))
        return res

    def solve_batch(x0s, xs_init=None, us_init=None):
        check_device(dev, x0s=x0s, xs_init=xs_init, us_init=us_init)
        solve_batch.stats = dict(main_s=0.0, rescue_s=0.0, launches=[],
                                 rescued=torch.zeros((), dtype=torch.int64, device=dev))
        t0 = time.perf_counter()
        res = staged(x0s, xs_init, us_init, scales, ub_stages, "main")
        t1 = time.perf_counter()
        solve_batch.stats.update(main_s=t1 - t0, main_diverged=res.diverged.sum())
        if not rescue_size:
            return res
        R = min(rescue_size, x0s.shape[0])
        # diverged lanes first; torch's default sort is not stable
        idx = torch.argsort((~res.diverged).to(torch.int8), stable=True)[:R]
        res_r = staged(x0s[idx], None, None, rescue_scales, rescue_ub_stages, "rescue")
        take = res.diverged[idx] & ~res_r.diverged

        def merge(full, r):
            if full.dim() == 2 and full.shape[1] == 0:      # an empty log series
                return full
            out = full.clone()
            out[idx] = torch.where(take.view((-1,) + (1,) * (r.dim() - 1)), r, full[idx])
            return out

        out = SolveResult(*(merge(f, r) for f, r in zip(res[:-1], res_r[:-1])),
                          log=SolveLog(*(merge(f, r) for f, r in zip(res.log, res_r.log))))
        solve_batch.stats.update(rescue_s=time.perf_counter() - t1, rescued=take.sum())
        return out

    solve_batch.stats = {}
    return solve_batch
