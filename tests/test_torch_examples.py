"""The port's example scripts (``aslr_to_tpu_torch/examples/``), the
counterparts of ``examples/``: each ``main`` on the CPU at the smallest
size it takes, and the command line of one. The examples whose work is
more than a preset's solve (the batched sweep, the warm re-solve, the
tracking MPC's target arc) are held to the same computation through the
JAX package at the test's sizes, in float64, to the tolerances of
``torch_lane_support.check_against_jax`` (cost rtol 1e-8, controls and
states atol 1e-8, equal iterations and flags).
"""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aslr_to_tpu.ops import rigid_body as jax_rbd
from aslr_to_tpu.ops.se3 import SE3 as JaxSE3
from aslr_to_tpu.parallel.batch import convergence_summary as jax_summary
from aslr_to_tpu.parallel.batch import make_batched_solver as jax_batched_solver
from aslr_to_tpu.solvers.ddp import SolverSettings as JaxSettings
from aslr_to_tpu.solvers.ddp import solve as jax_solve
from aslr_to_tpu.solvers.problem import stack_knots as jax_stack_knots
from aslr_to_tpu.workloads.presets import two_dof_sea as jax_sea
from aslr_to_tpu.workloads.presets import two_dof_vsa_boxddp as jax_vsa
from aslr_to_tpu_torch.examples import (batched_sweep, double_pendulum, mpc_resolve,
                                        mpc_tracking, seven_dof_sea, two_dof_sea,
                                        two_dof_vsa_boxddp, two_dof_vsa_modified)
from aslr_to_tpu_torch.examples import cli
from torch_lane_support import check_against_jax


def _same_solve(res, ref):
    """One scenario's result against JAX's: iterations and flags equal,
    cost rtol 1e-8, controls and states atol 1e-8."""
    assert int(res.iterations) == int(ref.iterations)
    assert bool(res.converged) == bool(ref.converged)
    np.testing.assert_allclose(float(res.cost), float(ref.cost), rtol=1e-8)
    np.testing.assert_allclose(res.us.numpy(), np.asarray(ref.us), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.xs.numpy(), np.asarray(ref.xs), rtol=0, atol=1e-8)


def _finite_result(res, T, nu):
    assert res.us.shape == (T, nu) and res.xs.shape[0] == T + 1
    assert bool(torch.isfinite(res.cost)) and int(res.iterations) >= 1


@pytest.mark.parametrize("name,module,T,nu", [
    ("two_dof_sea", two_dof_sea, 10, 2),
    ("seven_dof_sea", seven_dof_sea, 5, 7),
    ("double_pendulum", double_pendulum, 5, 2),
    ("two_dof_vsa_modified", two_dof_vsa_modified, 10, 4),
])
def test_single_solve_examples(name, module, T, nu, capsys):
    out = module.main(T=T, maxiter=3, device="cpu")
    _finite_result(out.result, T, nu)
    assert bool(torch.isfinite(out.ee_final).all())
    assert "cost" in capsys.readouterr().out


@pytest.mark.parametrize("homotopy", [False, True], ids=["boxddp", "homotopy"])
def test_vsa_boxddp_example_exports_its_trajectory(tmp_path, homotopy):
    from scipy.io import loadmat

    out = two_dof_vsa_boxddp.main(T=10, maxiter=4, device="cpu", homotopy=homotopy,
                                  out=str(tmp_path / "vsa.mat"))
    _finite_result(out.result, 10, 4)
    mat = loadmat(tmp_path / "vsa.mat")
    np.testing.assert_array_equal(mat["u3"].ravel(), out.result.us[:, 2].numpy())


def test_batched_sweep_example_over_two_devices(capsys):
    """The sweep's timed solve (its x0s plus 1e-4) over two devices against
    the JAX package's ``jit(vmap(solve))`` of the same BoxDDP on the same
    initial states, lane by lane, and its ``convergence_summary`` against
    JAX's."""
    res, summary = batched_sweep.main(batch=4, T=10, maxiter=3, devices="cpu,cpu",
                                      dtype="float64")
    assert "solves/s on 2 device(s), a shard each, one after another" in capsys.readouterr().out
    x0s = batched_sweep.sweep_x0s(4, 8, torch.float64, "cpu") + 1e-4
    jw = jax_vsa(T=10)
    ref = jax_batched_solver(jw.problem, JaxSettings(maxiter=3, th_stop=1e-5), use_gaps=False,
                             bounds=jw.bounds, use_fast_path=False)(jnp.asarray(x0s.numpy()))
    check_against_jax(res, ref)
    jsum = jax_summary(ref)
    assert summary.keys() == jsum.keys() and summary["n"] == jsum["n"] == 4
    for k in ("converged_frac", "diverged_frac", "mean_iterations"):
        assert summary[k] == jsum[k], k
    for k in ("median_cost", "p90_cost", "max_cost"):
        np.testing.assert_allclose(summary[k], jsum[k], rtol=1e-8, err_msg=k)


def test_mpc_resolve_example():
    """The cold solve and the warm re-solve from one knot into the plan,
    with the plan shifted by a knot as the warm start, against the JAX
    script's two solves at T=10."""
    first, warm = mpc_resolve.main(T=10, maxiter=20, device="cpu")
    assert int(warm.iterations) <= int(first.iterations)
    p = jax_sea(T=10).problem
    settings = JaxSettings(maxiter=20, th_stop=1e-7)
    solve = jax.jit(lambda p, xs, us: jax_solve(p, xs, us, settings=settings, use_gaps=True))
    ref = solve(p, jnp.broadcast_to(p.x0, (11, 8)), jnp.zeros((10, 2)))   # its cold start
    _same_solve(first, ref)
    xs_ws = jnp.concatenate([ref.xs[1:], ref.xs[-1:]])
    us_ws = jnp.concatenate([ref.us[1:], ref.us[-1:]])
    ref_warm = solve(dataclasses.replace(p, x0=ref.xs[1]), xs_ws, us_ws)
    _same_solve(warm, ref_warm)


def _jax_tracking(T, maxiter):
    """The JAX script's tracking MPC at horizon T: the frame target swept
    along the arc a knot, the stacked problem solved by FDDP; the result
    and the end effector's distance from the target at knots 0, T/2, T."""
    w = jax_sea(T=T)
    base = w.problem.running

    def target_at(t):
        return jnp.asarray([0.01, 0.05 + 0.15 * t / T, 0.18])

    def with_target(t):
        diff = base.differential
        items = []
        for it in diff.costs.items:
            c = it.cost
            if hasattr(c, "residual") and hasattr(c.residual, "placement"):
                res = dataclasses.replace(
                    c.residual, placement=JaxSE3(c.residual.placement.rot, target_at(t)))
                c = dataclasses.replace(c, residual=res)
            items.append(dataclasses.replace(it, cost=c))
        costs = dataclasses.replace(diff.costs, items=tuple(items))
        return dataclasses.replace(base, differential=dataclasses.replace(diff, costs=costs))

    prob = dataclasses.replace(w.problem, running=jax_stack_knots(
        [with_target(t) for t in range(T)]), per_knot=True)
    res = jax.jit(lambda: jax_solve(prob, settings=JaxSettings(maxiter=maxiter, th_stop=1e-7),
                                    use_gaps=True))()
    errs = [float(jnp.linalg.norm(
        jax_rbd.frame_placement(w.problem.state.robot, res.xs[t][:2], w.ee_frame).trans
        - target_at(min(t, T - 1)))) for t in (0, T // 2, T)]
    return res, errs


def test_mpc_tracking_example_single_and_batched():
    """The single solve and its three tracking errors against the JAX
    script's at T=10; the batched lane route's run at B=4."""
    res, errs = mpc_tracking.main(T=10, maxiter=10, device="cpu")
    ref, ref_errs = _jax_tracking(10, 10)
    _same_solve(res, ref)
    np.testing.assert_allclose(errs, ref_errs, rtol=1e-8, atol=1e-12)
    assert errs[-1] < errs[0]
    out, summary = mpc_tracking.main(T=10, batch=4, reps=1, device="cpu")
    assert out.cost.shape == (4,) and summary["converged_frac"] > 0.0


def test_example_command_line(capsys):
    """``cli`` maps ``main``'s keywords to options, a flag for a bool."""
    out = cli(two_dof_sea.main, ["--T", "6", "--maxiter", "2", "--device", "cpu"])
    _finite_result(out.result, 6, 2)
    assert "Finally reached" in capsys.readouterr().out
