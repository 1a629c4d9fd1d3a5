"""The port's terminal-weight homotopy against the JAX package, float64.

- the schedules (``stiffness_continuation``, ``rescue_continuation``) and
  ``scale_terminal_costs`` equal the JAX package's exactly, on the bounded
  VSA arm and on the SEA arm (``(DEFAULT_SCALES, None)``);
- the generic ``homotopy_solve``, the lane route's homotopy (plain versions
  on the CPU, with and without the stage boxes, with ``keep_log``) and the
  fast route's (scales only: each stage at its own terminal weight) match
  JAX's ``jit(vmap(homotopy_solve))`` at the tolerances of
  ``tests/test_lane_solver.py::_check`` (cost rtol 1e-8, xs and us atol
  1e-8, iterations and flags equal), as ``tests/test_lane_solver.py:143-175``
  and ``tests/test_homotopy.py:74-97`` hold the JAX routes; the lane route's
  log equals the log JAX's last stage's ``solve`` keeps;
- the diverged-lane rescue: a lane at x0 = inf stays diverged, the lanes the
  main pass solved keep its result to the bit, and the rescued lanes equal
  JAX's homotopy under the rescue schedule on the lanes that
  ``np.argsort(~diverged, kind="stable")[:R]`` picks, with R above and
  below the count of diverged lanes.

T=10, B=4, maxiter 3 a stage. The settings cap the regularization at 1e-8
(``reg_max``) so that, at this small size, some lanes diverge in the main
pass and some of those not in the rescue (at the default 1e9 none diverges
within the budget). The JAX references take the problem, the initial
states and the schedule as arguments: one compile for each schedule shape
(4 stages without boxes, 5 and 7 with).
"""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aslr_to_tpu.solvers.ddp import SolverSettings as JaxSettings
from aslr_to_tpu.solvers.homotopy import DEFAULT_SCALES as JAX_DEFAULT_SCALES
from aslr_to_tpu.solvers.homotopy import homotopy_solve as jax_homotopy_solve
from aslr_to_tpu.solvers.homotopy import rescue_continuation as jax_rescue
from aslr_to_tpu.solvers.homotopy import scale_terminal_costs as jax_scale
from aslr_to_tpu.solvers.homotopy import stiffness_continuation as jax_stiffness
from aslr_to_tpu.workloads.presets import two_dof_sea as jax_sea
from aslr_to_tpu.workloads.presets import two_dof_vsa_boxddp as jax_vsa
from aslr_to_tpu_torch import (
    DEFAULT_SCALES,
    SolverSettings,
    homotopy_solve,
    make_batched_solver,
    rescue_continuation,
    scale_terminal_costs,
    stiffness_continuation,
    two_dof_sea,
    two_dof_vsa_boxddp,
)
from aslr_to_tpu_torch.convert import stages_from_numpy
from aslr_to_tpu_torch.kernels import build
from aslr_to_tpu_torch.kernels.vsa_kernels import build_fast_path
from torch_lane_support import check_against_jax, one_thread, x0_batch  # noqa: F401

T = 10
SETTINGS = dict(maxiter=3, th_stop=1e-5, boxqp_warm_iters=2, reg_max=1e-8)
X_SMALL = x0_batch(11, 4, 0.05)
# main pass / rescue (T=10, SETTINGS): lane 0 solved, lane 1 at x0 = inf,
# lane 2 diverged and rescued, lane 3 diverged in both
X_RESCUE = x0_batch(5, 6, 1.0)[[0, 1, 3, 4]]
X_RESCUE[1, 0] = np.inf


@functools.lru_cache(maxsize=None)
def _jax_workload():
    return jax_vsa(T=T)


@functools.lru_cache(maxsize=None)
def _jax_ref(with_boxes):
    """JAX's jit(vmap(homotopy_solve)) taking (problem, x0s, bounds, scales,
    ub_stages): one compile for each schedule shape."""
    st = JaxSettings(**SETTINGS)

    def one(p, x0, b, scales, ub):
        return jax_homotopy_solve(dataclasses.replace(p, x0=x0), settings=st, use_gaps=False,
                                  bounds=b, scales=scales, ub_stages=ub if with_boxes else None)

    return jax.jit(jax.vmap(one, in_axes=(None, 0, None, None, None)))


def _jax_solve(x0s, schedule):
    w = _jax_workload()
    scales, ub = schedule
    return _jax_ref(ub is not None)(w.problem, jnp.asarray(x0s), w.bounds,
                                    jnp.asarray(scales), ub)


def _port(x0s, schedule, route="lanes", keep_log=False, **kw):
    """The port's homotopy of the VSA arm on CPU tensors; no kernel may
    launch."""
    w = two_dof_vsa_boxddp(T=T, device="cpu")
    scales, ub = stages_from_numpy(*schedule)
    solve = make_batched_solver(w.problem, SolverSettings(**SETTINGS), use_gaps=False,
                                bounds=w.bounds, keep_log=keep_log, use_fast_path=route,
                                globalization="homotopy", scales=scales, ub_stages=ub, **kw)
    build.reset_launches()
    res = solve(torch.tensor(x0s))
    assert sum(build.LAUNCHES.values()) == 0
    return res


def _main_schedule():
    w = _jax_workload()
    return jax_stiffness(w.problem, w.bounds)


def _rescue_schedule():
    w = _jax_workload()
    return jax_rescue(w.problem, w.bounds)


@functools.lru_cache(maxsize=None)
def _lanes_with_boxes():
    return _port(X_SMALL, _main_schedule(), keep_log=True)


@functools.lru_cache(maxsize=None)
def _main_pass():
    return _port(X_RESCUE, _main_schedule(), keep_log=True)


@pytest.mark.parametrize("arm", ["vsa", "sea"])
def test_schedules_match_jax(arm):
    jw = (jax_vsa if arm == "vsa" else jax_sea)(T=T)
    pw = (two_dof_vsa_boxddp if arm == "vsa" else two_dof_sea)(T=T, device="cpu")
    assert DEFAULT_SCALES == JAX_DEFAULT_SCALES
    for jfn, pfn in ((jax_stiffness, stiffness_continuation), (jax_rescue, rescue_continuation)):
        j_scales, j_ub = jfn(jw.problem, jw.bounds)
        p_scales, p_ub = pfn(pw.problem, pw.bounds)
        assert tuple(p_scales) == tuple(j_scales)
        if arm == "sea":
            assert j_ub is None and p_ub is None
        else:
            assert p_ub.dtype == pw.bounds.ub.dtype and p_ub.device == pw.bounds.ub.device
            np.testing.assert_array_equal(p_ub.numpy(), np.asarray(j_ub))
    for scale in (1e-3, 0.25):
        j_items = jax_scale(jw.problem, scale).terminal.differential.costs.items
        p_items = scale_terminal_costs(pw.problem, scale).terminal.differential.costs.items
        assert [it.name for it in p_items] == [it.name for it in j_items]
        assert [float(it.weight) for it in p_items] == [float(it.weight) for it in j_items]
    # the running costs are left as they were
    assert scale_terminal_costs(pw.problem, 0.5).running is pw.problem.running


def test_stage_inputs_are_checked():
    w = two_dof_vsa_boxddp(T=4, device="cpu")
    p = dataclasses.replace(w.problem, x0=torch.zeros(1, 8, dtype=torch.float64))
    scales, ub = stiffness_continuation(w.problem, w.bounds)
    with pytest.raises(ValueError, match="requires bounds"):
        homotopy_solve(p, scales=scales, ub_stages=ub)
    with pytest.raises(ValueError, match="fast path"):
        homotopy_solve(p, bounds=w.bounds, fast=build_fast_path(w.problem, w.bounds),
                       scales=scales, ub_stages=ub)
    with pytest.raises(ValueError, match="one row per scale"):
        homotopy_solve(p, bounds=w.bounds, scales=scales, ub_stages=ub[:3])
    with pytest.raises(ValueError, match="lane route"):
        make_batched_solver(w.problem, use_fast_path=False, bounds=w.bounds,
                            globalization="homotopy", rescue_size=4)


def test_generic_homotopy_matches_jax():
    schedule = _main_schedule()
    check_against_jax(_port(X_SMALL, schedule, route=False), _jax_solve(X_SMALL, schedule))


@pytest.mark.parametrize("boxes", ["stage_boxes", "scales_only"])
def test_lane_homotopy_matches_jax(boxes):
    if boxes == "stage_boxes":
        schedule, res = _main_schedule(), _lanes_with_boxes()
    else:
        schedule = (JAX_DEFAULT_SCALES, None)
        res = _port(X_SMALL, schedule)
    check_against_jax(res, _jax_solve(X_SMALL, schedule))


def test_lane_keep_log_matches_jax():
    """The lane route's SolveLog ([B, maxiter], NaN past a lane's last
    iteration) against the log of JAX's last stage's solve."""
    res, ref = _lanes_with_boxes(), _jax_solve(X_SMALL, _main_schedule())
    for name in res.log._fields:
        got, want = getattr(res.log, name).numpy(), np.asarray(getattr(ref.log, name))
        assert got.shape == want.shape == (X_SMALL.shape[0], SETTINGS["maxiter"])
        rtol = 1e-6 if name == "stops" else 1e-8
        assert np.allclose(got, want, rtol=rtol, atol=1e-12, equal_nan=True), name


def test_fast_homotopy_matches_jax():
    """The fast route solves each stage at that stage's terminal weight (a
    weight frozen when the path was built would part from JAX at the first
    stage)."""
    schedule = (JAX_DEFAULT_SCALES, None)
    check_against_jax(_port(X_SMALL, schedule, route=True), _jax_solve(X_SMALL, schedule))


def _merge_expected(main, rescue, pick):
    """JAX's main pass with each picked lane replaced by its rescue where the
    main pass diverged and the rescue did not (as numpy arrays)."""
    out = {f: np.array(getattr(main, f)) for f in main._fields if f != "log"}
    out.update({f"log.{f}": np.array(getattr(main.log, f)) for f in main.log._fields})
    div_r = np.asarray(rescue.diverged)
    for j, lane in enumerate(pick):
        if out["diverged"][lane] and not div_r[j]:
            for key in out:
                src = rescue.log if key.startswith("log.") else rescue
                out[key][lane] = np.asarray(getattr(src, key.removeprefix("log.")))[j]
    return out


def _same_bits(a, b):
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0),
                                                             b.nan_to_num(0.0))


@pytest.mark.parametrize("rescue_size", [4, 2])
def test_rescue_matches_jax(rescue_size):
    main_ref = _jax_solve(X_RESCUE, _main_schedule())
    div = np.asarray(main_ref.diverged)
    assert div.tolist() == [False, True, True, True]      # the data's premise
    pick = np.argsort(~div, kind="stable")[:rescue_size]
    rescue_ref = _jax_solve(X_RESCUE[pick], _rescue_schedule())
    want = _merge_expected(main_ref, rescue_ref, pick)

    scales, ub = stages_from_numpy(*_rescue_schedule())
    res = _port(X_RESCUE, _main_schedule(), keep_log=True, rescue_scales=scales,
                rescue_ub_stages=ub, rescue_size=rescue_size)
    got = {f: getattr(res, f) for f in res._fields if f != "log"}
    got.update({f"log.{f}": getattr(res.log, f) for f in res.log._fields})
    for key in ("iterations", "converged", "diverged"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    # lane 2 is taken from the rescue; the lane at x0 = inf stays diverged
    assert want["diverged"].tolist() == [False, True, False, True]
    for key in ("cost", "reg") + tuple(k for k in got if k.startswith("log.")):
        rtol = 1e-6 if key == "log.stops" else 1e-8
        assert np.allclose(got[key].numpy(), want[key], rtol=rtol, atol=1e-12,
                           equal_nan=True), key
    for key in ("xs", "us"):
        assert np.allclose(got[key].numpy(), want[key], atol=1e-8, equal_nan=True), key
    assert np.allclose(got["stop"].numpy(), want["stop"], rtol=1e-6, equal_nan=True)

    # the lanes not taken from the rescue keep the main pass to the bit
    main = _main_pass()
    kept = [0, 1, 3]
    for f in main._fields:
        series = (zip(main.log, res.log) if f == "log"
                  else [(getattr(main, f), getattr(res, f))])
        for a, b in series:
            assert _same_bits(a[kept].double(), b[kept].double()), f
