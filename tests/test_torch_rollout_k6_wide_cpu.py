"""K6 at nl 7 in its wide layout on the CPU, against its plain version and
K3's first trial at B=1, 15 and 200 (the longest of the rollouts' g++ cases;
a file of its own, so that pytest-xdist's ``--dist loadfile`` runs it beside
the other rollout files). The CUDA sources compile with g++ against the
stand-ins of ``tests/cuda_on_cpu``, as ``test_torch_rollout_cpu.py`` says,
whose fixture and helpers it takes.
"""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import pytest
import torch

from aslr_to_tpu_torch.kernels import build, vsa_kernels
from cuda_on_cpu.tables import per_knot_target
from test_torch_rollout_cpu import DTYPES, _assert_same_bits, _k6_args, _ndof_args
from test_torch_rollout_cpu import roll_lib  # noqa: F401  (the fixture)


@pytest.mark.parametrize("tables", [False, True], ids=["shared", "tables"])
@pytest.mark.parametrize(**DTYPES)
@pytest.mark.parametrize("batch", [1, 15, 200])
def test_k6_nl7_wide_layout_on_cpu_matches_plain_and_first_trial(roll_lib, batch, dtype,
                                                                 tables):
    """K6 at nl 7 in its wide layout (8 lanes a trajectory: one RNEA sweep
    and at most one feedback row a lane, 8 trajectories a block; B=1, 15,
    200 end in a partial block), in the shared and the tables instance,
    equals its plain version and K3's first trial (K3 there in the general
    layout) to the bit at T=5, not a multiple of the 8 knots whose running
    costs the group defers."""
    T_ = 5
    args = _ndof_args(7, batch, dtype, T_, seed=1)
    if tables:
        args = list(args)
        args[0], tgt = per_knot_target(args[0], T_, dtype)
        args = tuple(args) + (tgt,)
    k6 = _k6_args(args)
    before = build.LAUNCHES["rollout1"]
    one = vsa_kernels.rollout1(*k6)
    assert build.LAUNCHES["rollout1"] == before + 1
    _assert_same_bits(one, vsa_kernels.rollout1_plain(*k6))
    first, _ = vsa_kernels.rollout2(*k6[:7], 0.5 * k6[6], *k6[7:])
    _assert_same_bits(one, first)
    assert float(torch.isfinite(one.cost).double().mean()) >= 0.5
