"""The port's generic per-scenario solver (``solvers/ddp.py::solve``)
against the JAX package's.

Each family (BoxDDP, FDDP, DDP, BoxFDDP) solves the same seeded initial
states (numpy, float64, T=12, B=4) with the port's
``make_batched_solver(..., use_fast_path=False)`` on the CPU and the JAX
package's, i.e. ``jit(vmap(solve))``, both with ``keep_log``, held to the
tolerances of ``tests/test_lane_solver.py::_check`` (cost rtol 1e-8, xs and
us atol 1e-8 — 1e-6 for BoxFDDP in the tight box, as
``tests/test_torch_lane_solver_boxfddp.py`` gives its reason — stop rtol
1e-6, reg rtol 1e-8, equal iterations and flags) and the log series to the
same tolerances, NaN where JAX has NaN. The golden fixtures
``vsa_boxddp_T30`` and ``sea_T40`` go through ``SolverBoxDDP`` and
``SolverFDDP`` at ``tests/test_golden.py``'s tolerances, with no JAX. The
generic route's line search, every step length in one batched rollout,
equals one trial a round with early exit to the bit (the double pendulum,
BoxFDDP in the tight box, DDP).
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aslr_to_tpu.parallel.batch import make_batched_solver as jax_batched_solver
from aslr_to_tpu.solvers.ddp import Bounds as JaxBounds
from aslr_to_tpu.solvers.ddp import SolverSettings as JaxSettings
from aslr_to_tpu.workloads.presets import two_dof_sea as jax_sea
from aslr_to_tpu.workloads.presets import two_dof_vsa_boxddp as jax_vsa
from aslr_to_tpu_torch import Bounds, SolverSettings, make_batched_solver, two_dof_sea
from aslr_to_tpu_torch import two_dof_vsa_boxddp
from aslr_to_tpu_torch.kernels import build
from aslr_to_tpu_torch.solvers import ddp

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TIGHT_BOX = ([-2.0, -2.0, 0.0, 0.0], [2.0, 2.0, 3.0, 3.0])
T = 12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x0s(seed, n, scale):
    return scale * np.random.default_rng(seed).standard_normal((n, 8))


CASES = {
    # arm, box ("preset" / "tight" / None), use_gaps, x0s, settings
    "boxddp": ("vsa", "preset", False, _x0s(1, 4, 0.05),
               dict(maxiter=6, th_stop=1e-7, boxqp_warm_iters=2)),
    "fddp": ("sea", None, True, _x0s(2, 4, 0.3), dict(maxiter=8, th_stop=1e-9)),
    "ddp": ("sea", None, False, _x0s(3, 4, 0.05), dict(maxiter=6, th_stop=1e-7)),
    "boxfddp": ("vsa", "tight", True, _x0s(9, 4, 0.05), dict(maxiter=6, th_stop=1e-7)),
}


def _problems(arm, box):
    if arm == "sea":
        return jax_sea(T=T).problem, None, two_dof_sea(T=T, device="cpu").problem, None
    jw, tw = jax_vsa(T=T), two_dof_vsa_boxddp(T=T, device="cpu")
    if box == "preset":
        return jw.problem, jw.bounds, tw.problem, tw.bounds
    return (jw.problem, JaxBounds(*map(jnp.array, TIGHT_BOX)), tw.problem,
            Bounds(*(torch.tensor(b, dtype=torch.float64) for b in TIGHT_BOX)))


def _close(got, want, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               equal_nan=True)


@pytest.mark.parametrize("case", list(CASES))
def test_generic_solve_matches_jax(case):
    arm, box, use_gaps, x0s, settings = CASES[case]
    jp, jb, tp, tb = _problems(arm, box)
    ref = jax_batched_solver(jp, JaxSettings(**settings), use_gaps=use_gaps, bounds=jb,
                             keep_log=True, use_fast_path=False)(jnp.asarray(x0s))
    build.reset_launches()
    res = make_batched_solver(tp, SolverSettings(**settings), use_gaps=use_gaps, bounds=tb,
                              keep_log=True)(torch.tensor(x0s))
    assert sum(build.LAUNCHES.values()) == 0
    atol = 1e-6 if case == "boxfddp" else 1e-8

    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_array_equal(res.diverged.numpy(), np.asarray(ref.diverged))
    _close(res.cost, ref.cost, rtol=1e-8)
    _close(res.us, ref.us, atol=atol)
    _close(res.xs, ref.xs, atol=atol)
    _close(res.stop, ref.stop, rtol=1e-6)
    _close(res.reg, ref.reg, rtol=1e-8)
    log, rlog = res.log, ref.log
    assert log.costs.shape == (4, settings["maxiter"])
    _close(log.costs, rlog.costs, rtol=1e-8)
    _close(log.regs, rlog.regs, rtol=1e-8)
    _close(log.steps, rlog.steps, rtol=1e-12)
    _close(log.gap_norms, rlog.gap_norms, rtol=1e-6, atol=1e-12)
    for name in ("stops", "d1", "d2"):
        _close(getattr(log, name), getattr(rlog, name), rtol=1e-6, atol=1e-10)
    if case == "fddp":
        # the gap-aware branches ran: infeasible iterations, backtracking
        assert np.nanmax(log.gap_norms.numpy()) > 1e-9
        assert np.nanmin(log.steps.numpy()) < 1.0


@pytest.mark.parametrize("fixture", ["vsa_boxddp_T30", "sea_T40"])
def test_golden_through_the_solver_classes(fixture):
    ref = np.load(os.path.join(GOLDEN, fixture + ".npz"))
    if fixture == "vsa_boxddp_T30":
        w = two_dof_vsa_boxddp(T=30, device="cpu")
        solver, us_init, maxiter = ddp.SolverBoxDDP(w.problem, w.bounds), None, 25
    else:
        w = two_dof_sea(T=40, device="cpu")
        xs = w.problem.x0.expand(w.problem.T, 8)
        solver, us_init, maxiter = ddp.SolverFDDP(w.problem), w.problem.quasi_static(xs), 60
    solver.th_stop = 1e-7
    res = solver.solve(us_init=us_init, maxiter=maxiter)
    assert res.us.shape == ref["us"].shape
    assert np.allclose(float(res.cost), float(ref["cost"]), rtol=1e-8)
    assert np.allclose(res.us.numpy(), ref["us"], atol=1e-6)
    assert int(res.iterations) == int(ref["iters"])


def test_indefinite_quu_retries_instead_of_raising():
    """A lane whose Quu is indefinite gets a NaN factor (not an exception),
    is flagged retryable, and leaves the other lanes as they were; in a
    solve the retry raises reg per lane, bw_retry_cap times a pass."""
    w = two_dof_sea(T=6, device="cpu")
    p = w.problem
    x0s = torch.tensor(_x0s(4, 3, 0.1))
    xs = x0s[:, None].expand(3, 7, 8)
    us = torch.zeros(3, 6, 2, dtype=torch.float64)
    pb = dataclasses.replace(p, x0=x0s)
    _, run, term, xnext, _ = ddp._linearize_core(pb, xs, us)
    fs = ddp._gaps(pb, xs, xnext)
    s = SolverSettings()
    good = ddp._backward(pb, run, term, fs, us, torch.full((3,), 1e-9, dtype=torch.float64),
                         True, None, s)
    bad = ddp._backward(pb, run, term, fs, us, torch.tensor([1e-9, -10.0, 1e-9],
                                                            dtype=torch.float64), True, None, s)
    assert bad.ok.tolist() == [True, False, True] and bool(bad.retryable[1])
    assert good.ok.all() and not good.retryable.any()
    for lane in (0, 2):
        assert torch.equal(bad.K[lane], good.K[lane])

    res = make_batched_solver(p, SolverSettings(maxiter=2, reg_init=-1.0), use_gaps=True,
                              keep_log=True)(x0s)
    # each pass: three x10 bumps in the retry loop, then x10 by the schedule
    assert res.log.regs[:, 0].tolist() == [-1e4] * 3
    assert res.iterations.tolist() == [2] * 3 and not res.converged.any()


@pytest.mark.parametrize("case", ["pendulum", "boxfddp", "ddp"])
def test_line_search_of_all_trials_at_once_equals_the_rounds(case, monkeypatch):
    """The generic route rolls out every step length at once; one trial a
    round with early exit (the fast route's line search, forced here on the
    generic route) gives the same solve to the bit: each lane takes its
    first accepting step length either way."""
    from aslr_to_tpu_torch import double_pendulum

    if case == "pendulum":
        p, tb, use_gaps = double_pendulum(T=10, device="cpu").problem, None, True
        x0s = torch.tensor([3.14] + [0.0] * 7) + torch.tensor(_x0s(7, 4, 0.05))
        settings = dict(maxiter=8, th_stop=1e-9)
    else:
        arm, box, use_gaps, x0, settings = CASES[case]
        _, _, p, tb = _problems(arm, box)
        x0s = torch.tensor(x0)
    s = SolverSettings(**settings)
    batched = make_batched_solver(p, s, use_gaps=use_gaps, bounds=tb, keep_log=True)(x0s)
    monkeypatch.setattr(ddp, "_all_trials_at_once", lambda fast: False)
    rounds = make_batched_solver(p, s, use_gaps=use_gaps, bounds=tb, keep_log=True)(x0s)
    for name, a, b in zip(batched._fields[:-1], batched[:-1], rounds[:-1]):
        assert torch.equal(a, b), name
    for name, a, b in zip(batched.log._fields, batched.log, rounds.log):
        assert torch.equal(a.nan_to_num(-1.0), b.nan_to_num(-1.0)), name
    assert float(np.nanmin(rounds.log.steps.numpy())) < 1.0     # backtracking ran
