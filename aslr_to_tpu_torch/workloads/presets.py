"""The reference workloads as declarative configs.

PyTorch counterpart of ``double_pendulum``, ``two_dof_sea``, ``three_dof_sea``,
``seven_dof_sea``, ``_two_dof_vsa``, ``two_dof_vsa_boxddp`` and
``two_dof_vsa_modified`` in ``aslr_to_tpu/workloads/presets.py``: the
reference ``examples/double_pendulum.py`` (the soft-actuated swing-up, an
underactuated SEA pendulum, FDDP, cold), ``examples/two_dof_sea.py`` (FDDP, quasi-static warm start; the
benchmark's warm re-solve headline), the same SEA reach on a 3-DoF chain and
on the 7-DoF arm (the benchmark's 7-DoF metric, ``bench.py:231-252``),
``examples/two_dof_vsa_boxddp.py`` (u in [-100, 100]^2 x [0, 100]^2; the
benchmark's primary metric) and ``examples/two_dof_vsa_modified.py`` (a
linear stiffness cost and a stiffness lower bound of 0.002).

The presets build on the card (``device="cuda"``) unless the caller names
another device; without a CUDA device that default raises, as torch does.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models import robots
from ..models.actuation import ActuationModelDoublePendulum, ASRActuation, VSAASRActuation
from ..models.costs import (
    ActivationModelQuad,
    ActivationModelWeightedQuad,
    CostModelDoublePendulum,
    CostModelResidual,
    CostModelStiffness,
    CostModelSum,
    ResidualModelControl,
    ResidualModelFramePlacementASR,
    ResidualModelState,
)
from ..models.dynamics import DifferentialSEADynamics, DifferentialVSADynamics
from ..models.integrator import IntegratedActionEuler
from ..models.state import StateASR
from ..ops.rigid_body import frame_placement
from ..ops.se3 import SE3
from ..solvers.ddp import Bounds
from ..solvers.problem import ShootingProblem


class Workload(NamedTuple):
    name: str
    problem: ShootingProblem
    bounds: Optional[Bounds]
    solver: str              # "fddp" | "boxddp"
    maxiter: int
    th_stop: float
    warm_start: bool         # quasi-static warm start (two_dof_sea.py:78)
    ee_frame: Optional[int]
    target: Optional[torch.Tensor]


def double_pendulum(T: int = 10, dt: float = 1e-2, dtype=torch.float64, device="cuda",
                    robot=None) -> Workload:
    """Soft-actuated double-pendulum swing-up (reference
    ``examples/double_pendulum.py``): the SEA pendulum with the first motor
    driven (``ActuationModelDoublePendulum``, the second control column
    zero and unweighted), the swing-up cost ``CostModelDoublePendulum``,
    FDDP, no box, cold from the hanging ``x0 = [3.14, 0, ...]``."""
    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    model = robot if robot is not None else robots.double_pendulum(dtype=dtype, device=device)
    state = StateASR(model)
    act = ActuationModelDoublePendulum(state, act_link=0, nu_=2)
    nu = act.nu

    xact = ActivationModelWeightedQuad(t([1.0] * 2 + [0.0] * 2 + [1.0] * 2 + [0.0] * 2))
    xreg = CostModelResidual(state, xact, ResidualModelState(state, state.zero(), nu))
    uact = ActivationModelWeightedQuad(t([1.0, 0.0]))
    ureg = CostModelResidual(state, uact, ResidualModelControl(state, nu))
    pend_w = ActivationModelWeightedQuad(t([1.0] * 4 + [0.1] * 2))
    x_pend = CostModelDoublePendulum(state, pend_w, nu)

    running_costs = (
        CostModelSum(state, nu)
        .add_cost("uReg", ureg, 1e-1)
        .add_cost("xReg", xreg, 1e-2)
        .add_cost("xGoalR", x_pend, 1e-1)
    )
    terminal_costs = CostModelSum(state, nu).add_cost("xGoal", x_pend, 1e4)

    K = 1.0 * torch.eye(2, dtype=dtype, device=device)
    B = 1e-3 * torch.eye(2, dtype=dtype, device=device)
    running = IntegratedActionEuler(DifferentialSEADynamics(state, act, running_costs, K, B), dt)
    terminal = IntegratedActionEuler(
        DifferentialSEADynamics(state, act, terminal_costs, K, B), 0.0)

    x0 = t([3.14, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    problem = ShootingProblem(x0=x0, running=running, terminal=terminal, T=T)
    return Workload(
        name="double_pendulum", problem=problem, bounds=None, solver="fddp",
        maxiter=100, th_stop=1e-9, warm_start=False, ee_frame=None, target=None)


def two_dof_sea(T: int = 100, dt: float = 1e-2, dtype=torch.float64, device="cuda",
                robot=None) -> Workload:
    """2-DoF SEA arm reach (reference ``examples/two_dof_sea.py``): FDDP,
    no box, quasi-static warm start."""
    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    model = (robot if robot is not None
             else robots.asr_twodof(dtype=dtype, device=device)).with_gravity([9.81, 0.0, 0.0])
    state = StateASR(model)
    act = ASRActuation(state)
    nu = act.nu
    ee = model.frame_id("EE")
    target = t([0.01, 2.03063311e-01, 1.80000000e-01])

    frame_res = ResidualModelFramePlacementASR(
        state, ee, SE3(torch.eye(3, dtype=dtype, device=device), target), nu)
    goal = CostModelResidual(state, ActivationModelQuad(), frame_res)
    xact = ActivationModelWeightedQuad(t([1.0] * 2 + [0.0] * 2 + [1.0] * 2 + [0.0] * 2))
    xreg = CostModelResidual(state, xact, ResidualModelState(state, state.zero(), nu))
    ureg = CostModelResidual(state, ActivationModelQuad(), ResidualModelControl(state, nu))

    running_costs = (
        CostModelSum(state, nu)
        .add_cost("gripperPose", goal, 1e-1)
        .add_cost("xReg", xreg, 1e-3)
        .add_cost("uReg", ureg, 1e-2)
    )
    terminal_costs = CostModelSum(state, nu).add_cost("gripperPose", goal, 1e4)

    K = 1.0 * torch.eye(2, dtype=dtype, device=device)
    B = 0.01 * torch.eye(2, dtype=dtype, device=device)
    running = IntegratedActionEuler(DifferentialSEADynamics(state, act, running_costs, K, B), dt)
    terminal = IntegratedActionEuler(
        DifferentialSEADynamics(state, act, terminal_costs, K, B), 0.0)

    problem = ShootingProblem(x0=torch.zeros(state.nx, dtype=dtype, device=device),
                              running=running, terminal=terminal, T=T)
    return Workload(
        name="two_dof_sea", problem=problem, bounds=None, solver="fddp",
        maxiter=100, th_stop=1e-7, warm_start=True, ee_frame=ee, target=target)


def _sea_reach(name, model, q_tgt, T, dt, dtype, device) -> Workload:
    """The n-DoF SEA reach (JAX ``three_dof_sea`` and ``seven_dof_sea``):
    FDDP, no box, quasi-static warm start; the goal is the gripper pose at
    the bent posture ``q_tgt``, the spring K = I and the motor inertia B =
    0.01 I."""
    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    model = model.with_gravity([0.0, 0.0, -9.81])
    state = StateASR(model)
    act = ASRActuation(state)
    nu, nq = act.nu, model.nq
    ee = model.frame_id("gripper")
    tgt = frame_placement(model, t(q_tgt), ee)

    frame_res = ResidualModelFramePlacementASR(state, ee, SE3(tgt.rot, tgt.trans), nu)
    goal = CostModelResidual(state, ActivationModelQuad(), frame_res)
    xact = ActivationModelWeightedQuad(t([1.0] * nq + [0.0] * nq + [1.0] * nq + [0.0] * nq))
    xreg = CostModelResidual(state, xact, ResidualModelState(state, state.zero(), nu))
    ureg = CostModelResidual(state, ActivationModelQuad(), ResidualModelControl(state, nu))

    running_costs = (
        CostModelSum(state, nu)
        .add_cost("gripperPose", goal, 1e-1)
        .add_cost("xReg", xreg, 1e-3)
        .add_cost("uReg", ureg, 1e-2)
    )
    terminal_costs = CostModelSum(state, nu).add_cost("gripperPose", goal, 1e4)

    K = 1.0 * torch.eye(nq, dtype=dtype, device=device)
    B = 0.01 * torch.eye(nq, dtype=dtype, device=device)
    running = IntegratedActionEuler(DifferentialSEADynamics(state, act, running_costs, K, B), dt)
    terminal = IntegratedActionEuler(
        DifferentialSEADynamics(state, act, terminal_costs, K, B), 0.0)

    problem = ShootingProblem(x0=torch.zeros(state.nx, dtype=dtype, device=device),
                              running=running, terminal=terminal, T=T)
    return Workload(
        name=name, problem=problem, bounds=None, solver="fddp", maxiter=100, th_stop=1e-7,
        warm_start=True, ee_frame=ee, target=tgt.trans)


def three_dof_sea(T: int = 100, dt: float = 1e-2, dtype=torch.float64,
                  device="cuda") -> Workload:
    """3-DoF SEA arm reach, the smallest chain above 2 DoF (ndx=12, nu=3):
    the 7-DoF reach's code at a size the CPU tests afford."""
    eye = np.eye(3)
    model = robots.make_chain(
        name="three_dof_sea",
        joint_pos=[[0.0, 0.0, 0.12], [0.02, 0.0, 0.1], [0.0, 0.01, 0.11]],
        joint_rot=[eye, robots._rot_x(0.1), robots._rot_y(-0.1)],
        axes=[[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]],
        masses=[1.5, 1.0, 0.6],
        coms=[[0.0, 0.01, 0.05], [0.04, 0.0, 0.04], [0.0, 0.0, 0.05]],
        inertias=[[2e-3, 2e-3, 1e-3], [1.5e-3, 1.5e-3, 8e-4], [8e-4, 8e-4, 4e-4]],
        frames=[("gripper", 2, eye, [0.0, 0.0, 0.1])],
        dtype=dtype,
        device=device,
    )
    return _sea_reach("three_dof_sea", model, [0.4, -0.5, 0.3], T, dt, dtype, device)


def seven_dof_sea(T: int = 100, dt: float = 1e-2, dtype=torch.float64,
                  device="cuda") -> Workload:
    """7-DoF SEA arm reach on ``robots.seven_dof_arm`` (nx=28, nu=7): the
    reference's ``talos_arm`` generality at the solve level, and the
    benchmark's 7-DoF metric."""
    return _sea_reach("seven_dof_sea", robots.seven_dof_arm(dtype=dtype, device=device),
                      [0.4, -0.5, 0.3, -0.8, 0.2, 0.6, -0.3], T, dt, dtype, device)


def _two_dof_vsa(T: int, dt: float, stiffness_cost: bool, k_lb: float,
                 dtype=torch.float64, device="cuda", x_weights=None,
                 u_weights=None, xreg_w: float = 1e-1, ureg_w: float = 1e-1,
                 goal_term_w: float = 4e4, robot=None) -> Workload:
    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    model = (robot if robot is not None
             else robots.asr_twodof(dtype=dtype, device=device)).with_gravity([9.81, 0.0, 0.0])
    state = StateASR(model)
    act = VSAASRActuation(state)
    nu = 2 * act.nu
    ee = model.frame_id("EE")
    target = t([0.01, 0.2, 0.18])

    frame_res = ResidualModelFramePlacementASR(
        state, ee, SE3(torch.eye(3, dtype=dtype, device=device), target), nu)
    goal = CostModelResidual(state, ActivationModelQuad(), frame_res)
    xact = ActivationModelWeightedQuad(t(x_weights if x_weights is not None else [1.0] * 8))
    xreg = CostModelResidual(state, xact, ResidualModelState(state, state.zero(), nu))
    uact = ActivationModelWeightedQuad(t(u_weights if u_weights is not None else [1.0] * 4))
    ureg = CostModelResidual(state, uact, ResidualModelControl(state, nu))

    running_costs = (
        CostModelSum(state, nu)
        .add_cost("gripperPose", goal, 1e0)
        .add_cost("xReg", xreg, xreg_w)
        .add_cost("uReg", ureg, ureg_w)
    )
    if stiffness_cost:
        vsa_cost = CostModelStiffness(state, nu, lamda=t(10.0),
                                      Kref=k_lb * torch.ones(nu // 2, dtype=dtype, device=device))
        running_costs = running_costs.add_cost("vsa", vsa_cost, 1e-2)
    terminal_costs = CostModelSum(state, nu).add_cost("gripperPose", goal, goal_term_w)

    B = 1e-3 * torch.eye(2, dtype=dtype, device=device)
    running = IntegratedActionEuler(DifferentialVSADynamics(state, act, running_costs, B), dt)
    terminal = IntegratedActionEuler(DifferentialVSADynamics(state, act, terminal_costs, B), 0.0)

    problem = ShootingProblem(x0=torch.zeros(state.nx, dtype=dtype, device=device),
                              running=running, terminal=terminal, T=T)
    bounds = Bounds(lb=t([-100.0, -100.0, k_lb, k_lb]), ub=t([100.0, 100.0, 100.0, 100.0]))
    return Workload(
        name="two_dof_vsa", problem=problem, bounds=bounds, solver="boxddp",
        maxiter=400, th_stop=1e-7, warm_start=False, ee_frame=ee, target=target)


def two_dof_vsa_boxddp(T: int = 200, dt: float = 1e-2, dtype=torch.float64,
                       device="cuda", robot=None) -> Workload:
    """VSA reach with BoxDDP bounds (u in [-100,100]^2, K in [0,100]^2,
    cold start)."""
    w = _two_dof_vsa(T, dt, stiffness_cost=False, k_lb=0.0, dtype=dtype,
                     device=device, robot=robot)
    return w._replace(name="two_dof_vsa_boxddp")


def two_dof_vsa_modified(T: int = 200, dt: float = 1e-2, dtype=torch.float64,
                         device="cuda", robot=None) -> Workload:
    """VSA with a linear stiffness cost and a tightened stiffness lower bound
    (reference ``examples/two_dof_vsa_modified.py``: K lower bound 0.002,
    lambda=10 stiffness cost, xReg 1e-3 / uReg 1e-2 with zeroed stiffness
    u-weights, terminal goal 1e4)."""
    w = _two_dof_vsa(T, dt, stiffness_cost=True, k_lb=0.002, dtype=dtype, device=device,
                     u_weights=[1.0, 1.0, 0.0, 0.0], xreg_w=1e-3, ureg_w=1e-2,
                     goal_term_w=1e4, robot=robot)
    return w._replace(name="two_dof_vsa_modified")


def with_frame_targets(problem: ShootingProblem, rot, trans) -> ShootingProblem:
    """A per-knot copy of a shared-model ``problem`` whose frame-placement
    goal at knot t aims at ``(rot[t], trans[t])`` (``[T, 3, 3]`` and ``[T,
    3]``, tensors or numpy arrays such as a JAX problem's stacked leaves):
    the construction of the reference's tracking MPC
    (``examples/mpc_tracking.py``), stacked by ``stack_knots``. The
    terminal model keeps its own target."""
    from ..solvers.problem import stack_knots

    base = problem.running
    like = problem.x0

    def t_(a):
        if isinstance(a, torch.Tensor):
            return a.to(dtype=like.dtype, device=like.device)
        return torch.as_tensor(np.array(a, dtype=np.float64), dtype=like.dtype,
                               device=like.device)

    def at_knot(t):
        diff = base.differential
        items = []
        for it in diff.costs.items:
            c = it.cost
            if isinstance(getattr(c, "residual", None), ResidualModelFramePlacementASR):
                res = dataclasses.replace(c.residual, placement=SE3(t_(rot[t]), t_(trans[t])))
                c = dataclasses.replace(c, residual=res)
            items.append(dataclasses.replace(it, cost=c))
        costs = dataclasses.replace(diff.costs, items=tuple(items))
        return dataclasses.replace(base, differential=dataclasses.replace(diff, costs=costs))

    running = stack_knots([at_knot(t) for t in range(problem.T)])
    return dataclasses.replace(problem, running=running, per_knot=True)


class _Presets(dict):
    """The presets by name; an unknown name raises ``KeyError`` naming the
    presets there are."""

    def __missing__(self, name):
        raise KeyError(f"unknown preset '{name}'; available: {sorted(self)}")


PRESETS = _Presets(
    double_pendulum=double_pendulum,
    two_dof_sea=two_dof_sea,
    two_dof_vsa_boxddp=two_dof_vsa_boxddp,
    two_dof_vsa_modified=two_dof_vsa_modified,
    seven_dof_sea=seven_dof_sea,
    three_dof_sea=three_dof_sea,
)
