"""aslr_to_tpu_torch — the PyTorch and CUDA port of ``aslr_to_tpu``.

Batched trajectory optimization for articulated soft robots on an NVIDIA
H100: the 2-DoF VSA and SEA arms' DDP, FDDP, BoxDDP and BoxFDDP solves
(shared-model or per-knot problems: a frame target and a control box a
knot), the 3- and 7-DoF SEA arms' FDDP solves and the soft-actuated
double-pendulum swing-up (with the rigid model family and the condensed
formulation beside it), by the generic per-scenario solver (the
reference), its fast path, or the lane solver, with their hot
kernels (linearization, the Box, FDDP and BoxFDDP Riccati backwards, the
two-trial and one-trial rollouts) and a multiply-add probe written by hand
in CUDA C++ for ``sm_90a`` (``csrc/``).
The JAX package ``aslr_to_tpu`` stays the reference that the port is
tested against. Presets and solves run on the card unless the caller
builds the problem on another device.

Importing the package builds nothing: the kernels compile with ``nvcc`` at
their first launch on a CUDA tensor (``kernels/build.py``). On CPU tensors
every kernel wrapper runs its plain PyTorch version.
"""

from .models.actuation import ActuationModelDoublePendulum, ASRActuation, VSAASRActuation
from .models.costs import (
    ActivationBounds,
    ActivationModelQuad,
    ActivationModelQuadraticBarrier,
    ActivationModelWeightedQuad,
    CostModelDoublePendulum,
    CostModelResidual,
    CostModelStiffness,
    CostModelSum,
    ResidualModelControl,
    ResidualModelDoublePendulum,
    ResidualModelFramePlacementASR,
    ResidualModelState,
)
from .models.condensed import (
    ASRActuationCondensed,
    QbActuationModel,
    SoftDynamicsResidualModel,
    VSADynamicsResidualModel,
)
from .models.dynamics import (
    DifferentialFreeFwdDynamics,
    DifferentialSEADynamics,
    DifferentialVSADynamics,
)
from .models.integrator import IntegratedActionEuler
from .models.state import StateASR, StateMultibody
from .models import robots
from .ops.rigid_body import RobotModel
from .ops.se3 import SE3
from .solvers.ddp import (
    Bounds,
    SolveLog,
    SolveResult,
    SolverBoxDDP,
    SolverBoxFDDP,
    SolverDDP,
    SolverFDDP,
    SolverSettings,
    solve,
)
from .solvers.problem import ShootingProblem, stack_knots
from .workloads.presets import (
    double_pendulum,
    seven_dof_sea,
    three_dof_sea,
    two_dof_sea,
    two_dof_vsa_boxddp,
    two_dof_vsa_modified,
)
from .parallel.batch import convergence_summary, make_batched_solver
from .solvers.homotopy import (
    DEFAULT_SCALES,
    homotopy_solve,
    rescue_continuation,
    scale_terminal_costs,
    stiffness_continuation,
)
from .workloads.presets import PRESETS
from .workloads.run import WorkloadResult, run_workload, solve_workload

# the reference's names (python/aslr_to/__init__.py:1-9), as the JAX package
# aliases them
StateMultibodyASR = StateASR
DifferentialFreeASRFwdDynamicsModel = DifferentialSEADynamics
DifferentialFreeFwdDynamicsModelVSA = DifferentialVSADynamics
IntegratedActionModelEulerASR = IntegratedActionEuler

__all__ = [name for name in dir() if not name.startswith("_")]
__version__ = "0.1.0"
