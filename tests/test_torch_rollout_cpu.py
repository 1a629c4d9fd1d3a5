"""The rollouts (K3 and K6, ``csrc/rollout.cu``) run on the CPU.

The CUDA source compiles with g++ against the stand-ins of
``tests/cuda_on_cpu``: one thread per CUDA thread, __syncthreads at a
barrier over the block and the warp primitives at one over the warp (a shuffle whose mask leaves out its
own or its source lane reads NaN), cp.async as a copy, and shared memory
refilled with NaN bytes before each block, so an unstaged read shows. The
wrappers, pointed at that library, are held against their plain versions
on ragged batches: B=1, 15 and 33 take the one-element copies, B=40 the
16-byte ones, and each ends in a partial block (32 trajectories a block for
K6, 16 scenarios of two trials for K3). T=6 is not a multiple of the four
lanes of a group, so the running costs deferred to the group meet a ragged
tail. Cases: the VSA arm in its box, the VSA arm with gaps in a tight box,
and the SEA arm with gaps, unbounded; step lengths 1 and below 1, and
infeasible lanes among feasible ones. The 3-DoF SEA arm's gap instances run
at T=6 on the same batches (and one NaN trajectory), the 7-DoF arm's at
T=5, B=9; K6 at nl 7, whose wide layout puts a trajectory on 8 lanes in
blocks of 8 trajectories, with one NaN trajectory among the four of its
warp, and its launch (grid, block, shared memory) beside K3's there (its
cases at B=1, 15 and 200 with and without the target table sit in
``test_torch_rollout_k6_wide_cpu.py``). K3 at nl 7 in both of its
layouts (the SM count that the stand-in reports, ``cpu_cuda_sm_count``,
steers its batch rule): B=1, 12 and 15 at T=5, shared and with the target
table, and one NaN scenario in each. The per-knot tables (a
target a knot; [T, nu] boxes with one knot pinched; every row different) run on the VSA's box and the SEA's gaps at
B=1, 15 and 200, and tables of equal rows against the shared route.

The kernel performs its plain version's operations in the same order, so
the two agree to the bit, NaNs included, in f64 and f32: the kernel builds
with -ffp-contract=off, and the plain versions run here with the C
library's sin, cos and atan2 (and a correctly rounded square root) in place
of PyTorch's CPU kernels, whose vectorized loops round some results
differently in the last bit.
"""
import ctypes

import numpy as np
import pytest
import torch

from aslr_to_tpu_torch import Bounds, seven_dof_sea, three_dof_sea, two_dof_sea
from aslr_to_tpu_torch import two_dof_vsa_boxddp
from aslr_to_tpu_torch.kernels import build, vsa_kernels
from cuda_on_cpu.gxx import gxx_library, ieee_sqrt, libm
from cuda_on_cpu.tables import box_tables, per_knot_target

T = 6
VARIANTS = ("vsa_box", "vsa_box_gaps", "sea_gaps")
DTYPES = dict(argnames="dtype", argvalues=[torch.float64, torch.float32], ids=["f64", "f32"])


@pytest.fixture(scope="module")
def roll_lib(tmp_path_factory):
    """rollout.cu, its n-DoF units and the units of the table instances built
    for the CPU; the wrappers launch
    them on CPU tensors, and the plain versions take the C library's
    transcendentals, while the fixture lasts."""
    handle = gxx_library(tmp_path_factory.mktemp("rollout_kernel"),
                         ["rollout.cu", "rollout_n3.cu", "rollout_n7.cu", "rollout_tables.cu",
                          "rollout_n3_tables.cu", "rollout_n7_tables.cu"], "roll_smem",
                         ["aslr_rollout2", "aslr_rollout1", "aslr_rollout2_tables",
                          "aslr_rollout1_tables", "aslr_rollout_n7_launch"])
    mp = pytest.MonkeyPatch()
    mp.setattr(build, "_lib", handle)
    mp.setattr(vsa_kernels, "_route", lambda t: "kernel")
    mp.setattr(build, "stream_of", lambda t: None)
    mp.setattr(torch, "sqrt", ieee_sqrt)
    mp.setattr(torch, "sin", libm("sin", 1))
    mp.setattr(torch, "cos", libm("cos", 1))
    mp.setattr(torch, "atan2", libm("atan2", 2))
    yield handle
    mp.undo()


def _args(variant, B, dtype, seed=0):
    """K3's arguments (spec, xs, us, k, K, x0, alpha_a, alpha_b, wterm, lb,
    ub, fs, infeas): a random reference trajectory and gains; alpha_a 1 and
    alpha_b 1/2, 1/4, 1/8 by lane; lanes 0, 3, 6, ... infeasible."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=dtype)

    if variant == "sea_gaps":
        spec = vsa_kernels.extract_vsa_spec(two_dof_sea(T=T, dtype=dtype, device="cpu").problem,
                                            None)
        scale = np.array([3.0, 3.0])
    else:
        w = two_dof_vsa_boxddp(T=T, dtype=dtype, device="cpu")
        # with gaps, the tight box of tests/test_torch_rollout.py: in the
        # preset's wide one the stiff motor side soon makes the rollout chaotic
        bounds = (w.bounds if variant == "vsa_box" else
                  Bounds(t([-2.0, -2.0, 0.0, 0.0]), t([2.0, 2.0, 3.0, 3.0])))
        spec = vsa_kernels.extract_vsa_spec(w.problem, bounds)
        scale = np.array([3.0, 3.0, 2.0, 2.0])
    nu = scale.size
    xs = 0.1 * rng.standard_normal((T + 1, 8, B))
    us = rng.standard_normal((T, nu, B)) * scale[:, None]
    k = 0.5 * rng.standard_normal((T, nu, B))
    if nu == 4:     # stiffness steps that push the stiffness below the box's 0
        us[:, 2:] = np.abs(us[:, 2:])
        k[:, 2:] = us[:, 2:] + 3.0 * np.abs(rng.standard_normal((T, 2, B)))
    K = 0.1 * rng.standard_normal((T, nu, 8, B))
    x0 = xs[0] + 0.01 * rng.standard_normal((8, B))
    box = [None, None]
    if spec.lb is not None:
        box = [t(np.repeat(np.asarray(b, dtype=float)[:, None], B, axis=1))
               for b in (spec.lb, spec.ub)]
    gaps = [None, None]
    if variant.endswith("gaps"):
        gaps = [t(0.05 * rng.standard_normal((T + 1, 8, B))), t(np.arange(B) % 3 == 0)]
    return (spec, t(xs), t(us), t(k), t(K), t(x0), t(np.ones(B)),
            t(0.5 ** (1 + np.arange(B) % 3)), torch.full((B,), spec.w_goal_term, dtype=dtype),
            *box, *gaps)


def _assert_same_bits(got, want):
    for name, g, w in zip(want._fields, got, want):
        assert torch.equal(g.isnan(), w.isnan()), name
        assert torch.equal(g.nan_to_num(0.0), w.nan_to_num(0.0)), name


def _k6_args(args):
    """K6's arguments: K3's with the second trial's step lengths."""
    return args[:6] + args[7:]


@pytest.mark.parametrize(**DTYPES)
@pytest.mark.parametrize("batch", [1, 15, 33, 40])
@pytest.mark.parametrize("variant", VARIANTS)
def test_rollout2_on_cpu_matches_plain_version(roll_lib, variant, batch, dtype):
    args = _args(variant, batch, dtype)
    before = build.LAUNCHES["rollout2"]
    got = vsa_kernels.rollout2(*args)
    assert build.LAUNCHES["rollout2"] == before + 1
    want = vsa_kernels.rollout2_plain(*args)
    for g, w in zip(got, want):
        _assert_same_bits(g, w)
    # most lanes stay finite, and the trials differ
    assert float(torch.isfinite(got[1].cost).double().mean()) >= 0.5
    assert not torch.equal(got[0].us, got[1].us)
    if variant == "vsa_box":        # some controls sit on the box
        on = (got[1].us == args[9][None]) | (got[1].us == args[10][None])
        assert bool(on.any())


@pytest.mark.parametrize(**DTYPES)
@pytest.mark.parametrize("batch", [1, 15, 33, 40])
@pytest.mark.parametrize("variant", VARIANTS)
def test_rollout1_on_cpu_matches_plain_and_first_trial(roll_lib, variant, batch, dtype):
    """K6 at alpha equals its plain version, and K3's first trial at alpha
    to the bit (the same trajectory code)."""
    args = _k6_args(_args(variant, batch, dtype))
    before = build.LAUNCHES["rollout1"]
    got = vsa_kernels.rollout1(*args)
    assert build.LAUNCHES["rollout1"] == before + 1
    _assert_same_bits(got, vsa_kernels.rollout1_plain(*args))
    first, _ = vsa_kernels.rollout2(*args[:7], 0.5 * args[6], *args[7:])
    _assert_same_bits(got, first)


@pytest.mark.parametrize("kernel", ["rollout2", "rollout1"])
def test_rollout_on_cpu_keeps_a_trajectory_in_its_group(roll_lib, kernel):
    """Scenario 25's gains NaN: its trajectory fails alone; the other
    trajectories of its warp (24-31) stay finite and equal the plain
    version."""
    args = list(_args("vsa_box", 40, torch.float64))
    for i in (3, 4):
        args[i] = args[i].clone()
        args[i][..., 25] = float("nan")
    if kernel == "rollout1":
        args = _k6_args(args)
    got = getattr(vsa_kernels, kernel)(*args)
    want = getattr(vsa_kernels, kernel + "_plain")(*args)
    for g, w in zip(got, want) if kernel == "rollout2" else [(got, want)]:
        _assert_same_bits(g, w)
        assert bool(g.cost[25].isnan())
        assert bool(torch.isfinite(g.cost[[24, 26, 27, 28, 29, 30, 31]]).all())


def _ndof_args(nl, B, dtype, T_, seed=0):
    """K3's arguments on the 3- or 7-DoF SEA arm with gaps, unboxed (the
    n-DoF instances): as :func:`_args`, lanes 0, 3, 6, ... infeasible."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=dtype)

    w = (three_dof_sea if nl == 3 else seven_dof_sea)(T=T_, dtype=dtype, device="cpu")
    spec = vsa_kernels.extract_vsa_spec(w.problem, None)
    ndx = 4 * nl
    xs = 0.1 * rng.standard_normal((T_ + 1, ndx, B))
    us = 3.0 * rng.standard_normal((T_, nl, B))
    k = 0.5 * rng.standard_normal((T_, nl, B))
    K = 0.1 * rng.standard_normal((T_, nl, ndx, B))
    x0 = xs[0] + 0.01 * rng.standard_normal((ndx, B))
    return (spec, t(xs), t(us), t(k), t(K), t(x0), t(np.ones(B)),
            t(0.5 ** (1 + np.arange(B) % 3)), torch.full((B,), spec.w_goal_term, dtype=dtype),
            None, None, t(0.05 * rng.standard_normal((T_ + 1, ndx, B))),
            t(np.arange(B) % 3 == 0))


NDOF_CASES = dict(argnames="nl,batch,dtype", argvalues=[
    (3, 1, torch.float64), (3, 15, torch.float64), (3, 33, torch.float64),
    (3, 40, torch.float64), (3, 33, torch.float32), (7, 9, torch.float64)],
    ids=lambda v: str(v).replace("torch.", ""))


@pytest.mark.parametrize(**NDOF_CASES)
def test_ndof_rollouts_on_cpu_match_plain_version(roll_lib, nl, batch, dtype):
    """K3 and K6 at the 3- and 7-DoF SEA arms' gap instances (T=6 at nl 3,
    not a multiple of the group's 4 lanes; T=5 at nl 7), each against its
    plain version, and K6 against K3's first trial."""
    args = _ndof_args(nl, batch, dtype, 6 if nl == 3 else 5)
    got = vsa_kernels.rollout2(*args)
    for g, w in zip(got, vsa_kernels.rollout2_plain(*args)):
        _assert_same_bits(g, w)
    assert float(torch.isfinite(got[1].cost).double().mean()) >= 0.5
    assert not torch.equal(got[0].us, got[1].us)
    k6 = _k6_args(args)
    before = build.LAUNCHES["rollout1"]
    one = vsa_kernels.rollout1(*k6)
    assert build.LAUNCHES["rollout1"] == before + 1
    _assert_same_bits(one, vsa_kernels.rollout1_plain(*k6))
    first, _ = vsa_kernels.rollout2(*k6[:7], 0.5 * k6[6], *k6[7:])
    _assert_same_bits(one, first)


@pytest.mark.parametrize("kernel", ["rollout2", "rollout1"])
def test_ndof_rollout_on_cpu_keeps_a_trajectory_in_its_group(roll_lib, kernel):
    """The 3-DoF arm with scenario 25's gains NaN: its trajectory fails
    alone; the rest of its warp stays finite and equals the plain version."""
    args = list(_ndof_args(3, 40, torch.float64, 6))
    for i in (3, 4):
        args[i] = args[i].clone()
        args[i][..., 25] = float("nan")
    if kernel == "rollout1":
        args = _k6_args(args)
    got = getattr(vsa_kernels, kernel)(*args)
    want = getattr(vsa_kernels, kernel + "_plain")(*args)
    for g, w in zip(got, want) if kernel == "rollout2" else [(got, want)]:
        _assert_same_bits(g, w)
        assert bool(g.cost[25].isnan())
        assert bool(torch.isfinite(g.cost[[24, 26, 27, 28, 29, 30, 31]]).all())


def test_rollout_refuses_a_variant_it_has_no_instance_for(roll_lib):
    """The 3-DoF arm in a box without gaps (BoxDDP's rollout, which the JAX
    package's n-DoF lane route cannot take) has no instance: the wrappers
    raise before any launch and name the instances there are."""
    args = list(_ndof_args(3, 4, torch.float64, 6)[:11])
    args[9], args[10] = (torch.full((3, 4), b, dtype=torch.float64) for b in (-1.0, 1.0))
    before = dict(build.LAUNCHES)
    with pytest.raises(NotImplementedError, match="no kernel instance for nl=3 sea box;"):
        vsa_kernels.rollout2(*args)
    with pytest.raises(NotImplementedError,
                       match="nl=3 sea gaps, nl=3 sea, nl=3 sea box gaps, nl=7 sea gaps"):
        vsa_kernels.rollout1(*_k6_args(args))
    assert build.LAUNCHES == before


def _table_args(variant, B, dtype):
    """K3's arguments with a target a knot (its [T, 12] table) and, for the
    VSA's box, [T, nu] box tables with knot 3's torques pinched; the rows
    of each table all differ."""
    args = list(_args(variant, B, dtype))
    spec, tgt = per_knot_target(args[0], T, dtype)
    if variant == "vsa_box":
        lb, ub = box_tables(T, spec.nu, dtype, pinch=3)
        spec = spec._replace(lb=lb.double().numpy(), ub=ub.double().numpy())
        args[9], args[10] = lb, ub
    args[0] = spec
    return tuple(args) + (tgt,)


@pytest.mark.parametrize(**DTYPES)
@pytest.mark.parametrize("batch", [1, 15, 200])
@pytest.mark.parametrize("variant", ["vsa_box", "sea_gaps"])
def test_rollouts_on_cpu_read_the_tables(roll_lib, variant, batch, dtype):
    """K3 and K6 with the per-knot tables: each knot's clip reads its row
    of the box tables, and each deferred running cost the target row of its
    own knot (not the chain's); equal to the plain versions to the bit, and
    K6 to K3's first trial."""
    args = _table_args(variant, batch, dtype)
    got = vsa_kernels.rollout2(*args)
    for g, w in zip(got, vsa_kernels.rollout2_plain(*args)):
        _assert_same_bits(g, w)
    assert float(torch.isfinite(got[1].cost).double().mean()) >= 0.5
    if variant == "vsa_box":        # the pinched knot clamps
        assert bool((got[0].us[3, :2].abs() == 0.05).any())
    k6 = _k6_args(args)
    one = vsa_kernels.rollout1(*k6)
    _assert_same_bits(one, vsa_kernels.rollout1_plain(*k6))
    first, _ = vsa_kernels.rollout2(*k6[:7], 0.5 * k6[6], *k6[7:])
    _assert_same_bits(one, first)


@pytest.mark.parametrize(**DTYPES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_rollouts_on_cpu_equal_rows_give_the_shared_bits(roll_lib, variant, dtype):
    """Tables whose rows are all the shared box and the shared target give
    the shared route's xs, us and cost, kernel against kernel."""
    args = list(_args(variant, 40, dtype))
    spec = args[0]
    shared = vsa_kernels.rollout2(*args)
    tgt = torch.tensor(spec.target_table(T, dtype))
    if spec.lb is not None:
        lb, ub = (np.tile(np.asarray(b, dtype=float), (T, 1)) for b in (spec.lb, spec.ub))
        args[0] = spec._replace(lb=lb, ub=ub)
        args[9], args[10] = torch.tensor(lb, dtype=dtype), torch.tensor(ub, dtype=dtype)
    tabled = vsa_kernels.rollout2(*args, tgt=tgt)
    for g, w in zip(tabled, shared):
        _assert_same_bits(g, w)


@pytest.mark.parametrize(**dict(NDOF_CASES, argvalues=[
    (3, 15, torch.float64), (3, 33, torch.float32), (7, 9, torch.float64)]))
def test_ndof_rollouts_on_cpu_read_the_target_table(roll_lib, nl, batch, dtype):
    """The 3- and 7-DoF table instances with a target a knot (T=6 at nl 3,
    T=5 at nl 7): equal to the plain versions to the bit, K6 to K3's first
    trial."""
    T_ = 6 if nl == 3 else 5
    args = list(_ndof_args(nl, batch, dtype, T_))
    args[0], tgt = per_knot_target(args[0], T_, dtype)
    args = tuple(args) + (tgt,)
    got = vsa_kernels.rollout2(*args)
    for g, w in zip(got, vsa_kernels.rollout2_plain(*args)):
        _assert_same_bits(g, w)
    k6 = _k6_args(args)
    one = vsa_kernels.rollout1(*k6)
    _assert_same_bits(one, vsa_kernels.rollout1_plain(*k6))
    first, _ = vsa_kernels.rollout2(*k6[:7], 0.5 * k6[6], *k6[7:])
    _assert_same_bits(one, first)


def test_k6_nl7_wide_layout_on_cpu_keeps_a_trajectory_in_its_group(roll_lib):
    """K6 at nl 7 with trajectory 25's gains NaN: it fails alone; the other
    trajectories of its warp (24, 26, 27: four a warp at 8 lanes) equal the
    plain version and stay finite."""
    args = list(_k6_args(_ndof_args(7, 40, torch.float64, 5, seed=1)))
    for i in (3, 4):
        args[i] = args[i].clone()
        args[i][..., 25] = float("nan")
    got = vsa_kernels.rollout1(*args)
    _assert_same_bits(got, vsa_kernels.rollout1_plain(*args))
    assert bool(got.cost[25].isnan())
    assert bool(torch.isfinite(got.cost[[24, 26, 27]]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_nl7_rollout_launches_on_cpu(roll_lib, dtype):
    """At nl 7 on an H100's 132 SMs, K6 runs blocks of 64 threads (8
    trajectories a block) on two stages of a 266-row tile (8 columns and 32
    bytes), in f64 a slot a thread for the 35 values of the knot whose
    running cost it defers, and each group's ring of its last 8 knots'
    rotations (7 matrices a knot, 63 values a thread): 128 blocks at
    B=1024. K3 takes its wide layout at B=1024, where its general one would
    fill 64 blocks of 16 scenarios: 128 blocks of 128 threads (8 scenarios,
    two trials; a tile row of 8 columns and 32 bytes, the f64 slots, the
    rings), and its general one at B=4096, 256 blocks (a row of 16 columns
    and 32 bytes)."""
    size = torch.empty(0, dtype=dtype).element_size()
    rows = 28 + 7 + 7 + 7 * 28 + 28
    kept = (35 if size == 8 else 0) + 63

    def launch(kernel, B):
        return build.launch_of(kernel, dtype, B) | dict(blocks_per_sm=0)

    assert launch("rollout1", 1024) == dict(
        grid=128, threads=64, smem=(2 * rows * (8 + 32 // size) + 64 * kept) * size,
        blocks_per_sm=0, layout="wide")
    assert launch("rollout2", 1024) == dict(
        grid=128, threads=128, smem=(2 * rows * (8 + 32 // size) + 128 * kept) * size,
        blocks_per_sm=0, layout="wide")
    assert launch("rollout2", 4096) == dict(
        grid=256, threads=128, smem=2 * rows * (16 + 32 // size) * size, blocks_per_sm=0,
        layout="general")


@pytest.fixture
def sm_count(roll_lib):
    """The SMs that the CPU stand-in reports to a launcher, restored after
    the test."""
    count = ctypes.c_int.in_dll(roll_lib, "cpu_cuda_sm_count")
    saved = count.value
    yield count
    count.value = saved


# the SMs the stand-in reports for each of K3's layouts at nl 7: at an
# H100's 132 the general layout's blocks of 16 scenarios would leave SMs
# free at these batches, so the launch takes the wide one; at 1, every
# batch fills the card with general blocks
K3_LAYOUTS = dict(argnames="layout,sms", argvalues=[("wide", 132), ("general", 1)],
                  ids=["wide", "general"])


@pytest.mark.parametrize("tables", [False, True], ids=["shared", "tables"])
@pytest.mark.parametrize(**DTYPES)
@pytest.mark.parametrize("batch", [1, 12, 15])
@pytest.mark.parametrize(**K3_LAYOUTS)
def test_k3_nl7_layouts_on_cpu_match_plain_version(roll_lib, sm_count, layout, sms, batch,
                                                   dtype, tables):
    """K3 at nl 7 in the layout its launch picks (wide: 8 lanes a
    trajectory, 8 scenarios a block; general: 4 lanes, 16 scenarios), in the
    shared and the tables instance (a target a knot, every row different),
    equal to its plain version to the bit at T=5, a multiple of neither
    group's lanes; B=1, 12 and 15 end in partial blocks of both layouts (12
    with 16-byte copies), and K3's first trial equals K6 (wide at every
    batch) at its step length."""
    sm_count.value = sms
    assert build.launch_of("rollout2", dtype, batch)["layout"] == layout
    T_ = 5
    args = _ndof_args(7, batch, dtype, T_, seed=2)
    if tables:
        args = list(args)
        args[0], tgt = per_knot_target(args[0], T_, dtype)
        args = tuple(args) + (tgt,)
    before = build.LAUNCHES["rollout2"]
    got = vsa_kernels.rollout2(*args)
    assert build.LAUNCHES["rollout2"] == before + 1
    for g, w in zip(got, vsa_kernels.rollout2_plain(*args)):
        _assert_same_bits(g, w)
    assert float(torch.isfinite(got[1].cost).double().mean()) >= 0.5
    assert not torch.equal(got[0].us, got[1].us)
    _assert_same_bits(vsa_kernels.rollout1(*args[:6], *args[7:]), got[1])


@pytest.mark.parametrize(**K3_LAYOUTS)
def test_k3_nl7_layouts_on_cpu_keep_a_trajectory_in_its_group(roll_lib, sm_count, layout,
                                                              sms):
    """K3 at nl 7 in either layout with scenario 25's gains NaN: both its
    trials fail alone; the other scenarios of its warp (24-27 in the wide
    layout, 24-31 in the general one) equal the plain version and stay
    finite."""
    sm_count.value = sms
    assert build.launch_of("rollout2", torch.float64, 40)["layout"] == layout
    args = list(_ndof_args(7, 40, torch.float64, 5, seed=1))
    for i in (3, 4):
        args[i] = args[i].clone()
        args[i][..., 25] = float("nan")
    got = vsa_kernels.rollout2(*args)
    want = vsa_kernels.rollout2_plain(*args)
    mates = [24, 26, 27] if layout == "wide" else [24, 26, 27, 28, 29, 30, 31]
    for g, w in zip(got, want):
        _assert_same_bits(g, w)
        assert bool(g.cost[25].isnan())
        assert bool(torch.isfinite(g.cost[mates]).all())
