"""K3 and K6 at nl 7 (the 7-DoF SEA arm's wide layout, ``csrc/rollout.cuh``)
run on the CPU in every variant, with trajectories that blow up.

The CUDA sources compile with g++ against the stand-ins of
``tests/cuda_on_cpu`` (one thread per CUDA thread, __syncthreads at a
barrier over the block and the warp primitives at one over the warp, a
shuffle whose mask leaves out its own or its source lane reading NaN, shared
memory refilled with NaN bytes before each block). The wrappers, pointed at
that library, are held to their plain versions to the bit, NaNs included,
in f64 and f32, and K6 to K3's first trial at its step length, in each
variant: DDP's ("sea": no box, no gaps), BoxFDDP's ("sea box gaps": a box
that binds, gaps), FDDP's ("sea gaps") and FDDP's with a target a knot (the
table instance, every row different). The body under test: the knot's
serial tail split over the group's rows (the Cholesky factor a column a
pass), the rotations a knot's lanes make kept in a ring in shared memory,
which the sweeps and the deferred running costs read.

Each case runs at T=5, which is not a multiple of the 8 knots whose running
costs a group defers, at B=1, 15 and 20 (K6: 8 trajectories a block, K3: 8
scenarios of two trials; 15 and 20 end in partial blocks, 20 after two
whole ones). Among the scenarios of B=15 and 20: one whose gains are NaN,
one whose first link angle starts at 2e5 rad, past the 105,615 rad where
sinf and cosf leave their fast range reduction, and one whose second link
angle starts at -inf; at B=1 the one scenario starts past the fast range.
"""
import numpy as np
import pytest
import torch

from aslr_to_tpu_torch import seven_dof_sea
from aslr_to_tpu_torch.kernels import build, vsa_kernels
from aslr_to_tpu_torch.measure import SEVENDOF_BOX
from cuda_on_cpu.gxx import gxx_library, ieee_sqrt, libm
from cuda_on_cpu.tables import per_knot_target

T = 5
BEYOND = 2e5        # a link angle past sinf's fast range (105,615 rad)
VARIANTS = ("sea", "sea_box_gaps", "sea_gaps", "sea_gaps_tables")


@pytest.fixture(scope="module")
def n7_handle(tmp_path_factory):
    return gxx_library(tmp_path_factory.mktemp("rollout_n7_kernel"),
                       ["rollout.cu", "rollout_n3.cu", "rollout_n7.cu", "rollout_n7_sea.cu",
                        "rollout_n7_box.cu", "rollout_tables.cu", "rollout_n3_tables.cu",
                        "rollout_n7_tables.cu"], "roll_smem",
                       ["aslr_rollout2", "aslr_rollout1", "aslr_rollout2_tables",
                        "aslr_rollout1_tables", "aslr_rollout_n7_launch"])


@pytest.fixture
def n7_lib(n7_handle, monkeypatch):
    """The wrappers launch the CPU build on CPU tensors, and the plain
    versions take the C library's sin, cos and atan2 and a correctly rounded
    square root, for the test."""
    monkeypatch.setattr(build, "_lib", n7_handle)
    monkeypatch.setattr(vsa_kernels, "_route", lambda t: "kernel")
    monkeypatch.setattr(build, "stream_of", lambda t: None)
    monkeypatch.setattr(torch, "sqrt", ieee_sqrt)
    monkeypatch.setattr(torch, "sin", libm("sin", 1))
    monkeypatch.setattr(torch, "cos", libm("cos", 1))
    monkeypatch.setattr(torch, "atan2", libm("atan2", 2))
    return n7_handle


def _args(variant, B, dtype, seed=0):
    """K3's arguments (spec, xs, us, k, K, x0, alpha_a, alpha_b, wterm, lb,
    ub[, fs, infeas][, tgt]): a random reference trajectory and gains,
    alpha_a 1 and alpha_b 1/2, 1/4, 1/8 by lane; with gaps, lanes 0, 3, 6,
    ... infeasible; the box the sevendof_box path's, which controls of
    3 randn cross; the scenarios that blow up as the module says."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=dtype)

    spec = vsa_kernels.extract_vsa_spec(
        seven_dof_sea(T=T, dtype=dtype, device="cpu").problem, None)
    xs = 0.1 * rng.standard_normal((T + 1, 28, B))
    us = 3.0 * rng.standard_normal((T, 7, B))
    k = 0.5 * rng.standard_normal((T, 7, B))
    K = 0.1 * rng.standard_normal((T, 7, 28, B))
    x0 = xs[0] + 0.01 * rng.standard_normal((28, B))
    if B == 1:
        x0[0, 0] = BEYOND
    else:
        k[..., 3], K[..., 3] = np.nan, np.nan
        x0[0, 4] = BEYOND
        x0[1, 5] = -np.inf
    box, gaps = [None, None], []
    if variant == "sea_box_gaps":
        top = np.repeat(np.asarray(SEVENDOF_BOX)[:, None], B, axis=1)
        box = [t(-top), t(top)]
        spec = spec._replace(lb=-np.asarray(SEVENDOF_BOX), ub=np.asarray(SEVENDOF_BOX))
    if variant != "sea":
        gaps = [t(0.05 * rng.standard_normal((T + 1, 28, B))), t(np.arange(B) % 3 == 0)]
    tgt = []
    if variant == "sea_gaps_tables":
        spec, table = per_knot_target(spec, T, dtype)
        tgt = [table]
    return (spec, t(xs), t(us), t(k), t(K), t(x0), t(np.ones(B)),
            t(0.5 ** (1 + np.arange(B) % 3)), torch.full((B,), spec.w_goal_term, dtype=dtype),
            *box, *gaps, *tgt)


def _k6(args):
    """K6's arguments: K3's with the second trial's step lengths."""
    return args[:6] + args[7:]


def _assert_same_bits(got, want):
    for name, g, w in zip(want._fields, got, want):
        assert torch.equal(g.isnan(), w.isnan()), name
        assert torch.equal(g.nan_to_num(0.0), w.nan_to_num(0.0)), name


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("batch", [1, 15, 20])
@pytest.mark.parametrize("variant", VARIANTS)
def test_nl7_rollouts_on_cpu_match_plain_version(n7_lib, variant, batch, dtype):
    """K3 and K6 at nl 7 in the variant's instance equal their plain versions
    to the bit, blown-up trajectories included, and K6 equals K3's first
    trial; the blown-up scenarios blow up, and the box clips."""
    args = _args(variant, batch, dtype)
    assert build.launch_of("rollout2", dtype, 1024, variant=variant.replace(
        "_tables", "").replace("_", " "))["layout"] == "wide"
    before = dict(build.LAUNCHES)
    got = vsa_kernels.rollout2(*args)
    one = vsa_kernels.rollout1(*_k6(args))
    assert build.LAUNCHES["rollout2"] == before["rollout2"] + 1
    assert build.LAUNCHES["rollout1"] == before["rollout1"] + 1
    for g, w in zip(got, vsa_kernels.rollout2_plain(*args)):
        _assert_same_bits(g, w)
    _assert_same_bits(one, vsa_kernels.rollout1_plain(*_k6(args)))
    k6 = _k6(args)
    first, _ = vsa_kernels.rollout2(*k6[:7], 0.5 * k6[6], *k6[7:])
    _assert_same_bits(one, first)
    beyond = 0 if batch == 1 else 4
    assert float(got[0].xs[0, 0, beyond].abs()) > 105615.0
    if batch > 1:
        assert bool(got[0].cost[3].isnan()) and not bool(torch.isfinite(got[0].cost[5]))
        assert float(torch.isfinite(got[1].cost).double().mean()) >= 0.5
    if variant == "sea_box_gaps":
        lb, ub = args[9][None], args[10][None]
        assert bool(((got[1].us == lb) | (got[1].us == ub)).any())
