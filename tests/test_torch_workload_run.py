"""The port's workload runner, metrics and iteration table against the JAX
package, float64 on the CPU.

- ``run_workload`` on ``two_dof_sea`` (FDDP, quasi-static warm start) and
  on ``two_dof_vsa_boxddp`` with ``globalization="homotopy"`` (the
  stiffness-bound continuation), small T and explicit settings: the final
  end-effector translation, the control effort ``u_sq`` and the cost match
  JAX's ``run_workload`` (the generic route on both sides: the problem
  lives on the CPU), iterations and flags equal;
- ``utils/verbose.py::format_iteration_table`` gives JAX's text, on one log
  and on each package's own log of the same solve;
- the lane route's ``keep_log`` (``solve_workload(..., use_fast_path="lanes",
  verbose=True)``, plain versions on the CPU) equals JAX's ``solve`` log, and
  the table it prints is JAX's;
- ``PRESETS["double_pendulum"]`` builds the swing-up, and an unknown name
  raises ``KeyError`` naming the presets.
"""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import functools

import numpy as np
import pytest
import torch

from aslr_to_tpu.solvers.ddp import SolverSettings as JaxSettings
from aslr_to_tpu.utils.verbose import format_iteration_table as jax_format
from aslr_to_tpu.workloads.run import run_workload as jax_run_workload
from aslr_to_tpu_torch import PRESETS, SolverSettings, run_workload, solve_workload
from aslr_to_tpu_torch.kernels import build
from aslr_to_tpu_torch.utils.metrics import u_squared
from aslr_to_tpu_torch.utils.verbose import format_iteration_table
from torch_lane_support import one_thread  # noqa: F401

CASES = {
    # preset, T, settings, globalization
    "sea": ("two_dof_sea", 8, dict(maxiter=8, th_stop=1e-7), None),
    "vsa_homotopy": ("two_dof_vsa_boxddp", 8, dict(maxiter=2, th_stop=1e-5), "homotopy"),
}


@functools.lru_cache(maxsize=None)
def _both(case):
    name, T, settings, glob = CASES[case]
    ref = jax_run_workload(name, JaxSettings(**settings), globalization=glob, T=T)
    build.reset_launches()
    got = run_workload(name, SolverSettings(**settings), globalization=glob, T=T,
                       device="cpu")
    assert sum(build.LAUNCHES.values()) == 0
    return got, ref


@pytest.mark.parametrize("case", list(CASES))
def test_run_workload_matches_jax(case):
    got, ref = _both(case)
    r, rr = got.result, ref.result
    assert int(r.iterations) == int(rr.iterations)
    assert bool(r.converged) == bool(rr.converged) and bool(r.diverged) == bool(rr.diverged)
    assert np.allclose(float(r.cost), float(rr.cost), rtol=1e-8)
    assert got.ee_final.shape == (3,) and got.u_sq.shape == rr.us.shape[-1:]
    assert np.allclose(got.ee_final.numpy(), np.asarray(ref.ee_final), atol=1e-9)
    assert np.allclose(got.u_sq.numpy(), np.asarray(ref.u_sq), rtol=1e-8, atol=1e-9)
    assert np.allclose(r.us.numpy(), np.asarray(rr.us), atol=1e-8)


@pytest.mark.parametrize("case", list(CASES))
def test_iteration_table_matches_jax(case):
    got, ref = _both(case)
    jax_log = ref.result.log
    text = jax_format(jax_log, ref.result.iterations)
    assert text.startswith("iter     cost") and len(text.splitlines()) > 1
    # the same log gives the same text; each package's log of the solve too
    assert format_iteration_table(jax_log, ref.result.iterations) == text
    assert format_iteration_table(got.result.log, got.result.iterations) == text
    assert format_iteration_table(got.result.log, 0) == ""


def test_u_squared_sums_over_the_horizon():
    us = torch.tensor(np.random.default_rng(0).standard_normal((2, 5, 3)))
    assert np.allclose(u_squared(us).numpy(), (us.numpy() ** 2).sum(axis=1), rtol=1e-14)
    assert np.allclose(u_squared(us[0]).numpy(), (us[0].numpy() ** 2).sum(axis=0), rtol=1e-14)


def test_lane_keep_log_and_verbose_match_jax(capsys):
    """The lane route's log of the SEA solve against the log of JAX's
    generic solve, and the table that ``verbose`` prints."""
    _, ref = _both("sea")
    name, T, settings, _ = CASES["sea"]
    w = PRESETS[name](T=T, device="cpu")
    capsys.readouterr()
    res = solve_workload(w, SolverSettings(**settings), use_fast_path="lanes", verbose=True)
    printed = capsys.readouterr().out
    rr = ref.result
    assert int(res.iterations) == int(rr.iterations)
    for field in res.log._fields:
        got, want = getattr(res.log, field).numpy(), np.asarray(getattr(rr.log, field))
        assert got.shape == want.shape == (settings["maxiter"],)
        rtol = 1e-6 if field == "stops" else 1e-8
        assert np.allclose(got, want, rtol=rtol, atol=1e-12, equal_nan=True), field
    assert printed.rstrip("\n") == jax_format(rr.log, rr.iterations)


def test_double_pendulum_names_the_rigid_family():
    w = PRESETS["double_pendulum"](T=6, device="cpu")
    assert w.name == "double_pendulum" and w.problem.T == 6 and w.problem.nu == 2
    assert w.problem.state.robot.name == "double_pendulum"
    assert (w.solver, w.maxiter, w.th_stop, w.warm_start) == ("fddp", 100, 1e-9, False)
    with pytest.raises(KeyError, match="available: .*'double_pendulum'"):
        PRESETS["no_such_preset"]
