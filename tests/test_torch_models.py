"""The port's VSA and SEA models, presets and carried-across constants
against the JAX package's.

A random trajectory from a seeded numpy generator (float64) goes through
the JAX models' ``calc`` and the port's; tolerance 1e-12 relative to each
quantity's scale.
"""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aslr_to_tpu.pallas.vsa_kernels import extract_vsa_spec as jax_extract_vsa_spec
from aslr_to_tpu.workloads.presets import two_dof_sea as jax_sea
from aslr_to_tpu.workloads.presets import two_dof_vsa_boxddp as jax_preset
from aslr_to_tpu_torch import convert
from aslr_to_tpu_torch.kernels.vsa_kernels import extract_vsa_spec, pack_params
from aslr_to_tpu_torch.ops import rigid_body as trbd
from aslr_to_tpu_torch.workloads.presets import two_dof_sea, two_dof_vsa_boxddp

TOL = 1e-12
T = 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workloads():
    return jax_preset(T=T), two_dof_vsa_boxddp(T=T, device="cpu")


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=TOL * scale, rtol=0)


def test_model_calc_along_random_trajectory(workloads):
    jw, tw = workloads
    rng = np.random.default_rng(0)
    xs = 0.4 * rng.standard_normal((5, T + 1, 8))
    us = rng.standard_normal((5, T, 4)) * np.array([2.0, 2.0, 1.0, 1.0])
    us[..., 2:] = np.abs(us[..., 2:])
    jd = jax.jit(jax.vmap(jax.vmap(jw.problem.running.calc)))(
        jnp.asarray(xs[:, :-1]), jnp.asarray(us))
    td = tw.problem.running.calc(torch.tensor(xs[:, :-1]), torch.tensor(us))
    _close(td.cost.numpy(), jd.cost)
    _close(td.xnext.numpy(), jd.xnext)
    u0 = np.zeros((5, 4))
    jt = jax.jit(jax.vmap(jw.problem.terminal.calc))(jnp.asarray(xs[:, -1]), jnp.asarray(u0))
    tt = tw.problem.terminal.calc(torch.tensor(xs[:, -1]), torch.tensor(u0))
    _close(tt.cost.numpy(), jt.cost)
    _close(tt.xnext.numpy(), jt.xnext)
    _close(tw.problem.calc_cost(torch.tensor(xs), torch.tensor(us)).numpy(),
           jax.jit(jax.vmap(jw.problem.calc_cost))(jnp.asarray(xs), jnp.asarray(us)))
    _close(tw.problem.rollout(torch.tensor(us), torch.tensor(xs[:, 0])).numpy(),
           jax.jit(jax.vmap(lambda u, x0: jw.problem.rollout(u, x0)))(
               jnp.asarray(us), jnp.asarray(xs[:, 0])))


def test_preset_matches_jax(workloads):
    jw, tw = workloads
    assert tw.problem.T == jw.problem.T and tw.problem.nu == jw.problem.nu == 4
    assert tw.problem.state.nx == jw.problem.state.nx == 8
    assert tw.problem.running.dt == jw.problem.running.dt
    np.testing.assert_array_equal(tw.bounds.lb.numpy(), np.asarray(jw.bounds.lb))
    np.testing.assert_array_equal(tw.bounds.ub.numpy(), np.asarray(jw.bounds.ub))
    np.testing.assert_array_equal(tw.problem.x0.numpy(), np.asarray(jw.problem.x0))
    assert [it.name for it in tw.problem.running.differential.costs.items] == \
        [it.name for it in jw.problem.running.differential.costs.items]


def _spec_equal(a, b):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if name == "rc":
            for f in ("parents", "frame_parents"):
                assert tuple(getattr(x, f)) == tuple(getattr(y, f))
            for f in ("joint_rot", "joint_pos", "axis", "mass", "com", "inertia",
                      "gravity", "frame_rot", "frame_pos"):
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
        elif x is None or y is None or isinstance(x, str):
            assert x == y, name
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)


def test_spec_carried_from_jax_equals_port_spec(workloads):
    jw, tw = workloads
    jspec = jax_extract_vsa_spec(jw.problem, jw.bounds)
    fields = jspec._asdict()
    fields["rc"] = vars(jspec.rc)
    carried = convert.spec_from_numpy(fields)
    own = extract_vsa_spec(tw.problem, tw.bounds)
    _spec_equal(carried, own)
    np.testing.assert_array_equal(pack_params(carried), pack_params(own))


def test_robot_carried_from_jax(workloads):
    jw, tw = workloads
    jrobot = jw.problem.running.differential.state.robot
    fields = {f.name: getattr(jrobot, f.name) for f in dataclasses.fields(jrobot)}
    robot = convert.robot_from_numpy(fields, dtype=torch.float64)
    q = torch.tensor(np.random.default_rng(1).standard_normal((4, 2)))
    own = tw.problem.running.differential.state.robot
    np.testing.assert_array_equal(trbd.rnea(robot, q, q, q).numpy(),
                                  trbd.rnea(own, q, q, q).numpy())


@pytest.fixture(scope="module")
def sea_workloads():
    return jax_sea(T=T), two_dof_sea(T=T, device="cpu")


def test_sea_model_calc_and_quasi_static(sea_workloads):
    jw, tw = sea_workloads
    rng = np.random.default_rng(3)
    xs = 0.4 * rng.standard_normal((5, T + 1, 8))
    us = 2.0 * rng.standard_normal((5, T, 2))
    jd = jax.jit(jax.vmap(jax.vmap(jw.problem.running.calc)))(
        jnp.asarray(xs[:, :-1]), jnp.asarray(us))
    td = tw.problem.running.calc(torch.tensor(xs[:, :-1]), torch.tensor(us))
    _close(td.cost.numpy(), jd.cost)
    _close(td.xnext.numpy(), jd.xnext)
    _close(tw.problem.calc_cost(torch.tensor(xs), torch.tensor(us)).numpy(),
           jax.jit(jax.vmap(jw.problem.calc_cost))(jnp.asarray(xs), jnp.asarray(us)))
    _close(tw.problem.quasi_static(torch.tensor(xs[:, :-1])).numpy(),
           jax.jit(jax.vmap(jw.problem.quasi_static))(jnp.asarray(xs[:, :-1])))
    # the VSA's warm start: gravity torques on the motors, zero stiffness
    jv, tv = jax_preset(T=T), two_dof_vsa_boxddp(T=T, device="cpu")
    _close(tv.problem.quasi_static(torch.tensor(xs[:, :-1])).numpy(),
           jax.jit(jax.vmap(jv.problem.quasi_static))(jnp.asarray(xs[:, :-1])))


def test_sea_preset_and_spec_match_jax(sea_workloads):
    jw, tw = sea_workloads
    assert tw.problem.nu == jw.problem.nu == 2 and tw.bounds is None is jw.bounds
    assert (tw.solver, tw.warm_start, tw.maxiter, tw.th_stop) == \
        (jw.solver, jw.warm_start, jw.maxiter, jw.th_stop)
    jspec = jax_extract_vsa_spec(jw.problem, None)
    fields = jspec._asdict()
    fields["rc"] = vars(jspec.rc)
    carried = convert.spec_from_numpy(fields)
    own = extract_vsa_spec(tw.problem, None)
    _spec_equal(carried, own)
    assert own.variant == "sea" and own.nu == 2
    np.testing.assert_array_equal(own.K, np.eye(2))
    np.testing.assert_array_equal(pack_params(carried), pack_params(own))
