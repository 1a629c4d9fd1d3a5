"""The port's entry points (``aslr_to_tpu_torch/entry.py``), the
counterparts of ``__graft_entry__.py``: ``entry()``'s contract, which
``tests/test_graft_entry.py`` pins for the JAX package, held to the JAX
package's ``entry()`` in f64 on the CPU, and ``dryrun_multichip`` over two
CPU devices.
"""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import jax.numpy as jnp
import numpy as np
import torch

from aslr_to_tpu.parallel.batch import make_batched_solver as jax_batched_solver
from aslr_to_tpu.solvers.ddp import SolverSettings as JaxSettings
from aslr_to_tpu.workloads.presets import two_dof_vsa_boxddp as jax_vsa
from aslr_to_tpu_torch.entry import dryrun_multichip, entry
from aslr_to_tpu_torch.workloads.presets import two_dof_vsa_boxddp


def test_entry_runs_both_routes_and_they_agree():
    """``fn(x0s) -> (cost_sum, gen_us, lane_us)`` on the port's 4 example
    states and the JAX ``entry()``'s 4 (``PRNGKey(0)``), against the JAX
    ``fn``'s generic half on the same 8 states: its ``vmap(solve)`` of the
    VSA BoxDDP at T=20, maxiter 3, th_stop 1e-6, which the JAX package's
    ``make_batched_solver(use_fast_path=False)`` compiles. The JAX ``fn``'s
    lane half reaches the Pallas kernels, which run on the CPU only in
    interpret mode, so both of the port's routes are held to the JAX
    generic route: each route's controls to atol 1e-8, each route's cost
    (its controls rolled out and costed) to rtol 1e-8, and ``cost_sum`` to
    twice the JAX cost to rtol 1e-8 (``check_against_jax``'s tolerances).

    The port's lane 2 (velocities in its x0 that start the stiff arm's
    transients) is held to rtol 1e-7 in cost and atol 5e-7 in controls:
    at reg 1e-9 the port's generic route parts from JAX's there by 6.1e-8
    in cost and 2.0e-7 in controls, its lane route by 6.4e-9 and 2.0e-8,
    and the JAX package's own two routes part on it by 1.7e-8 in cost
    (amplified rounding, no control flips at a bound; ROADMAP Queue 3)."""
    import __graft_entry__ as jax_entry

    fn, args = entry(device="cpu", dtype=torch.float64)
    assert len(args) == 1 and args[0].shape == (4, 8)
    _, (jax_x0s,) = jax_entry.entry()
    x0s = torch.cat([args[0], torch.tensor(np.asarray(jax_x0s))])
    out = fn(x0s)
    assert len(out) == 3
    cost, gen_us, lane_us = out
    assert cost.shape == (8,) and gen_us.shape == lane_us.shape == (8, 20, 4)
    assert bool(torch.isfinite(cost).all())

    jw = jax_vsa(T=20)
    ref = jax_batched_solver(jw.problem, JaxSettings(maxiter=3, th_stop=1e-6), use_gaps=False,
                             bounds=jw.bounds, use_fast_path=False)(jnp.asarray(x0s.numpy()))
    ref_cost, ref_us = np.asarray(ref.cost), np.asarray(ref.us)
    p = two_dof_vsa_boxddp(T=20, device="cpu").problem
    steady = [0, 1, 3, 4, 5, 6, 7]
    for us in (gen_us, lane_us):
        route_cost = p.calc_cost(p.rollout(us, x0s), us).numpy()
        np.testing.assert_allclose(route_cost[steady], ref_cost[steady], rtol=1e-8)
        np.testing.assert_allclose(us.numpy()[steady], ref_us[steady], rtol=0, atol=1e-8)
        np.testing.assert_allclose(route_cost[2], ref_cost[2], rtol=1e-7)
        np.testing.assert_allclose(us.numpy()[2], ref_us[2], rtol=0, atol=5e-7)
    np.testing.assert_allclose(cost.numpy()[steady], 2 * ref_cost[steady], rtol=1e-8)
    np.testing.assert_allclose(cost.numpy()[2], 2 * ref_cost[2], rtol=1e-7)


def test_dryrun_multichip_on_two_cpu_devices():
    """The five families through ``sharded_solve`` over two devices."""
    dryrun_multichip(2, device_type="cpu", dtype=torch.float64)
