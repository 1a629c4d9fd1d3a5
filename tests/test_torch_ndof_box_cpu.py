"""The n-DoF SEA arms' box and DDP kernel instances run on the CPU: K5 at
(ndx, nu) = (12, 3) and (28, 7), and K3 and K6 at nl 3 and 7 without box or
gaps ("sea", DDP's rollout) and with a box of the lanes and gaps ("sea box
gaps", BoxFDDP's).

The CUDA sources compile with g++ against the stand-ins of
``tests/cuda_on_cpu`` (one thread per CUDA thread, __syncthreads at a barrier
over the block and the warp primitives at one over the warp, a shuffle whose mask leaves out its
own or its source lane reading NaN, shared memory refilled with NaN bytes
before each block). The wrappers, pointed at that library, are held to
their plain versions to the bit in f64 and f32, NaNs and flags included:

- K5 at (12, 3) (16 lanes a scenario, eight scenarios a block) and at
  (28, 7) (its wide layout: a warp a scenario, four a block, the BoxQP on
  the warp) at T=6 and T=4, warm and cold, at B=1, 15 and 33 (ragged last
  blocks; 15 and 33 take the one-element copies), in a box that binds
  (controls 3·randn, bounds about ±1-2), every tenth lane at a negative
  reg; and one NaN scenario that fails alone in its group;
- K3 and K6 at nl 3 (T=6) and 7 (T=5) in both variants at B=1, 15 and 40
  (K6 also against K3's first trial), K3 at nl 7 also in its general
  layout (the SM count that the stand-in reports steers its batch rule),
  and one NaN trajectory that fails alone in its group;
- the launches of the new 7-DoF instances (grid, threads, shared memory),
  and the refusals: K2 above ndx 8, a box without gaps at nl 3 and 7, and
  box tables there, each naming the instances that are built.
"""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import ctypes

import numpy as np
import pytest
import torch

from aslr_to_tpu_torch import seven_dof_sea, three_dof_sea
from aslr_to_tpu_torch.kernels import build, riccati, vsa_kernels
from cuda_on_cpu.gxx import gxx_library, ieee_sqrt, libm

DTYPES = dict(argnames="dtype", argvalues=[torch.float64, torch.float32], ids=["f64", "f32"])
NDOF_T = {3: 6, 7: 4}           # K5's horizons
ROLL_T = {3: 6, 7: 5}           # the rollouts': neither a multiple of a group's lanes


@pytest.fixture(scope="module")
def box_handle(tmp_path_factory):
    return gxx_library(tmp_path_factory.mktemp("ndof_box_kernel"), ["riccati_box.cu"],
                       "sweep_smem", ["aslr_riccati_box", "aslr_riccati_fddp",
                                      "aslr_riccati_boxfddp_n7_launch"])


@pytest.fixture(scope="module")
def roll_handle(tmp_path_factory):
    return gxx_library(tmp_path_factory.mktemp("ndof_rollout_kernel"),
                       ["rollout.cu", "rollout_n3.cu", "rollout_n3_sea.cu", "rollout_n3_box.cu",
                        "rollout_n7.cu", "rollout_n7_sea.cu", "rollout_n7_box.cu"], "roll_smem",
                       ["aslr_rollout2", "aslr_rollout1", "aslr_rollout_n7_launch"])


@pytest.fixture
def box_lib(box_handle, monkeypatch):
    """The wrappers launch the box kernel's CPU build on CPU tensors, and the
    plain versions take a correctly rounded square root, for the test."""
    monkeypatch.setattr(build, "_lib", box_handle)
    monkeypatch.setattr(riccati, "_route", lambda t: "kernel")
    monkeypatch.setattr(build, "stream_of", lambda t: None)
    monkeypatch.setattr(torch, "sqrt", ieee_sqrt)
    return box_handle


@pytest.fixture
def roll_lib(roll_handle, monkeypatch):
    """The same for the rollouts, whose plain versions also take the C
    library's sin, cos and atan2."""
    monkeypatch.setattr(build, "_lib", roll_handle)
    monkeypatch.setattr(vsa_kernels, "_route", lambda t: "kernel")
    monkeypatch.setattr(build, "stream_of", lambda t: None)
    monkeypatch.setattr(torch, "sqrt", ieee_sqrt)
    monkeypatch.setattr(torch, "sin", libm("sin", 1))
    monkeypatch.setattr(torch, "cos", libm("cos", 1))
    monkeypatch.setattr(torch, "atan2", libm("atan2", 2))
    count = ctypes.c_int.in_dll(roll_handle, "cpu_cuda_sm_count")
    saved = count.value
    yield roll_handle
    count.value = saved


def _box(nl, B, dtype):
    """A box of the lanes [nl, B] that controls of 3·randn cross: joint j
    in [-(1 + 0.1 j), 1.2 + 0.1 j]."""
    j = np.arange(nl)
    return [torch.tensor(np.repeat(b[:, None], B, axis=1), dtype=dtype)
            for b in (-(1.0 + 0.1 * j), 1.2 + 0.1 * j)]


def _assert_same_bits(got, want):
    for name, g, w in zip(want._fields, got, want):
        assert torch.equal(g.isnan(), w.isnan()), name
        assert torch.equal(g.nan_to_num(0.0), w.nan_to_num(0.0)), name


def _k5_args(nl, B, dtype, warm, seed=0):
    """K5's arguments on the 3- or 7-DoF SEA arm: the derivatives of a
    random trajectory with gaps, controls 3·randn in the box of ``_box``,
    kprev 0.5·randn (warm: 2 QP iterations) or None (cold: 6); every tenth
    lane at a negative reg."""
    rng = np.random.default_rng(seed)
    T_ = NDOF_T[nl]

    def t(a):
        return torch.tensor(a, dtype=dtype)

    w = (three_dof_sea if nl == 3 else seven_dof_sea)(T=T_, dtype=dtype, device="cpu")
    spec = vsa_kernels.extract_vsa_spec(w.problem, None)
    xs = t(0.3 * rng.standard_normal((T_ + 1, 4 * nl, B)))
    us = t(3.0 * rng.standard_normal((T_, nl, B)))
    lin = vsa_kernels.linearize_plain(spec, xs, us, torch.full((B,), spec.w_goal_term,
                                                                dtype=dtype))
    r = lin.run
    fs = torch.cat([torch.full_like(xs[:1], 0.01), lin.xnext - xs[1:]], dim=0)
    reg = t(np.where(np.arange(B) % 10 == 0, -0.05, 1e-9))
    kprev = t(0.5 * rng.standard_normal((T_, nl, B))) if warm else None
    lb, ub = _box(nl, B, dtype)
    return (r["Fx"], r["Fu"], r["Lx"], r["Lu"], r["Lxx"], r["Lxu"], r["Luu"], lin.term["Lx"],
            lin.term["Lxx"], fs, us, kprev, lb, ub, reg, 2 if warm else 6)


@pytest.mark.parametrize(**DTYPES)
@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("batch", [1, 15, 33])
@pytest.mark.parametrize("nl", [3, 7])
def test_ndof_boxfddp_kernel_on_cpu_matches_plain_version(box_lib, nl, batch, warm, dtype):
    """K5 at (12, 3) and, in its wide layout, (28, 7): equal to its plain
    version to the bit, flags included; some knots' QPs end on a bound."""
    args = _k5_args(nl, batch, dtype, warm)
    before = build.LAUNCHES["riccati_boxfddp"]
    got = riccati.riccati_boxfddp_backward(*args)
    assert build.LAUNCHES["riccati_boxfddp"] == before + 1
    _assert_same_bits(got, riccati.riccati_boxfddp_plain(*args))
    us, lb, ub = args[10], args[12], args[13]
    du = -got.k
    assert bool(((du == lb - us) | (du == ub - us)).any())
    if batch > 1:       # lane 0 (and 10) at a negative reg
        assert not bool(got.ok.all()) and bool(got.ok.any())
        assert bool(got.retryable.any()) and not bool(got.retryable.all())


@pytest.mark.parametrize("nl,batch,lane,mates", [(3, 33, 9, [8, 11, 12, 13]),
                                                 (7, 9, 5, [4, 6, 7])], ids=["nl3", "nl7"])
def test_ndof_boxfddp_kernel_on_cpu_keeps_a_scenario_in_its_group(box_lib, nl, batch, lane,
                                                                  mates):
    """One scenario's inputs NaN: it fails alone; the other scenarios of its
    warp (at 16 lanes) or block (a warp a scenario) keep ok and equal the
    plain version."""
    args = list(_k5_args(nl, batch, torch.float64, True))
    for i in range(9):
        args[i] = args[i].clone()
        args[i][..., lane] = float("nan")
    got = riccati.riccati_boxfddp_backward(*args)
    _assert_same_bits(got, riccati.riccati_boxfddp_plain(*args))
    assert not bool(got.ok[lane]) and bool(got.ok[mates].all())


@pytest.mark.parametrize("dtype,smem", [(torch.float32, 98176), (torch.float64, 194944)],
                         ids=["f32", "f64"])
def test_wide_boxfddp_launch_on_cpu(box_lib, dtype, smem):
    """At B=1024, K5 at (28, 7) runs 256 blocks of 128 threads (a warp a
    scenario), as K4 there; its tile adds the controls and the warm start
    (2,092 rows in f32, 2,090 in f64 on 16-byte sections) and its scratch
    the box: 98,176 bytes in f32 (two blocks an SM) and 194,944 in f64."""
    info = build.launch_of("riccati_boxfddp", dtype, 1024)
    assert (info["grid"], info["threads"], info["smem"]) == (256, 128, smem)


def test_box_kernel_refuses_what_is_not_built(box_lib):
    """K2 at (28, 7) (BoxDDP, which the JAX package's n-DoF lane route cannot
    take) and K5 with box tables at (12, 3) raise before any launch and name
    the instances."""
    args = list(_k5_args(3, 4, torch.float64, True))
    box_args = args[:9] + args[10:]
    seven = list(_k5_args(7, 2, torch.float64, True))
    before = dict(build.LAUNCHES)
    with pytest.raises(NotImplementedError,
                       match="no kernel instance for ndx=28 nu=7; its instances: ndx=8 nu=4, "
                             "ndx=8 nu=4 box tables"):
        riccati.riccati_box_backward(*(seven[:9] + seven[10:]))
    with pytest.raises(NotImplementedError, match="ndx=12 nu=3; its instances: ndx=8 nu=4"):
        riccati.riccati_box_backward(*box_args)
    lb, ub = (torch.tensor(np.tile(b, (6, 1))) for b in ([-1.0] * 3, [1.0] * 3))
    args[12], args[13] = lb, ub
    with pytest.raises(NotImplementedError,
                       match="ndx=12 nu=3 box tables; its instances: .*ndx=12 nu=3, ndx=28 nu=7"):
        riccati.riccati_boxfddp_backward(*args, per_knot_box=True)
    assert build.LAUNCHES == before


def _roll_args(nl, variant, B, dtype, seed=0):
    """K3's arguments on the 3- or 7-DoF SEA arm: a random reference
    trajectory and gains; alpha_a 1 and alpha_b 1/2, 1/4, 1/8 by lane;
    variant "sea" without box and gaps, "sea_box_gaps" in the box of
    ``_box`` with gaps, lanes 0, 3, 6, ... infeasible."""
    rng = np.random.default_rng(seed)
    T_ = ROLL_T[nl]

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
    box, gaps = [None, None], [None, None]
    if variant == "sea_box_gaps":
        box = _box(nl, B, dtype)
        spec = spec._replace(lb=box[0][:, 0].double().numpy(), ub=box[1][:, 0].double().numpy())
        gaps = [t(0.05 * rng.standard_normal((T_ + 1, ndx, B))), t(np.arange(B) % 3 == 0)]
    return (spec, t(xs), t(us), t(k), t(K), t(x0), t(np.ones(B)),
            t(0.5 ** (1 + np.arange(B) % 3)), torch.full((B,), spec.w_goal_term, dtype=dtype),
            *box, *gaps)


def _k6_args(args):
    """K6's arguments: K3's with the second trial's step lengths."""
    return args[:6] + args[7:]


def _check_rollouts(args):
    """K3 and K6 against their plain versions, K6 against K3's first trial;
    returns K3's trials."""
    before = build.LAUNCHES["rollout2"]
    got = vsa_kernels.rollout2(*args)
    assert build.LAUNCHES["rollout2"] == before + 1
    for g, w in zip(got, vsa_kernels.rollout2_plain(*args)):
        _assert_same_bits(g, w)
    k6 = _k6_args(args)
    before = build.LAUNCHES["rollout1"]
    one = vsa_kernels.rollout1(*k6)
    assert build.LAUNCHES["rollout1"] == before + 1
    _assert_same_bits(one, vsa_kernels.rollout1_plain(*k6))
    first, _ = vsa_kernels.rollout2(*k6[:7], 0.5 * k6[6], *k6[7:])
    _assert_same_bits(one, first)
    return got


@pytest.mark.parametrize(**DTYPES)
@pytest.mark.parametrize("batch", [1, 15, 40])
@pytest.mark.parametrize("variant", ["sea", "sea_box_gaps"])
@pytest.mark.parametrize("nl", [3, 7])
def test_ndof_rollout_variants_on_cpu_match_plain_version(roll_lib, nl, variant, batch, dtype):
    """K3 and K6 at nl 3 and 7 (nl 7: K6's wide layout, and K3's, which its
    batch rule picks on 132 SMs at these batches) in DDP's and BoxFDDP's
    variants: equal to their plain versions to the bit, K6 to K3's first
    trial; the boxed controls clip."""
    args = _roll_args(nl, variant, batch, dtype)
    if nl == 7:
        assert build.launch_of("rollout2", dtype, batch,
                               variant=variant.replace("_", " "))["layout"] == "wide"
    got = _check_rollouts(args)
    assert float(torch.isfinite(got[1].cost).double().mean()) >= 0.5
    assert not torch.equal(got[0].us, got[1].us)
    if variant == "sea_box_gaps":
        lb, ub = args[9][None], args[10][None]
        assert bool(((got[1].us == lb) | (got[1].us == ub)).any())


@pytest.mark.parametrize(**DTYPES)
@pytest.mark.parametrize("variant", ["sea", "sea_box_gaps"])
def test_k3_nl7_variants_on_cpu_general_layout(roll_lib, variant, dtype):
    """K3 at nl 7 in its general layout (4 lanes a trajectory, 16 scenarios
    a block), which its batch rule takes where the general blocks fill the
    SMs (here: one SM reported), in both variants at B=15."""
    ctypes.c_int.in_dll(roll_lib, "cpu_cuda_sm_count").value = 1
    assert build.launch_of("rollout2", dtype, 15,
                           variant=variant.replace("_", " "))["layout"] == "general"
    _check_rollouts(_roll_args(7, variant, 15, dtype, seed=1))


@pytest.mark.parametrize("variant", ["sea", "sea_box_gaps"])
@pytest.mark.parametrize("nl,mates", [(3, [24, 26, 27, 28, 29, 30, 31]), (7, [24, 26, 27])],
                         ids=["nl3", "nl7"])
def test_ndof_rollout_variants_on_cpu_keep_a_trajectory_in_its_group(roll_lib, nl, mates,
                                                                     variant):
    """Scenario 25's gains NaN: its trajectories fail alone; the rest of its
    warp (8 trajectories at 4 lanes, 4 at 8) stays finite and equals the
    plain version."""
    args = list(_roll_args(nl, variant, 40, torch.float64))
    for i in (3, 4):
        args[i] = args[i].clone()
        args[i][..., 25] = float("nan")
    for kernel, a in (("rollout2", args), ("rollout1", _k6_args(args))):
        got = getattr(vsa_kernels, kernel)(*a)
        want = getattr(vsa_kernels, kernel + "_plain")(*a)
        for g, w in zip(got, want) if kernel == "rollout2" else [(got, want)]:
            _assert_same_bits(g, w)
            assert bool(g.cost[25].isnan())
            assert bool(torch.isfinite(g.cost[mates]).all())


@pytest.mark.parametrize("variant,gaps", [("sea", False), ("sea box gaps", True)])
def test_nl7_rollout_variant_launches_on_cpu(roll_lib, variant, gaps):
    """The launch queries of the new 7-DoF variants: at B=1024 K6 runs 128
    blocks of 64 threads and K3 its wide layout, 128 blocks of 128; at
    B=4096 K3's general layout, 256 blocks; shared memory as the gap
    instance's but for the gaps' 28 rows (DDP's variant has none): two
    stages of the tile and, in the wide layout, each group's ring of its
    last 8 knots' rotations (63 values a thread)."""
    size = 4
    rows = 28 + 7 + 7 + 7 * 28 + (28 if gaps else 0)

    def launch(kernel, B):
        return build.launch_of(kernel, torch.float32, B, variant=variant) | dict(blocks_per_sm=0)

    assert launch("rollout1", 1024) == dict(grid=128, threads=64,
                                            smem=(2 * rows * (8 + 32 // size) + 64 * 63) * size,
                                            blocks_per_sm=0, layout="wide")
    assert launch("rollout2", 1024)["layout"] == "wide"
    assert launch("rollout2", 4096) == dict(grid=256, threads=128,
                                            smem=2 * rows * (16 + 32 // size) * size,
                                            blocks_per_sm=0, layout="general")


def test_rollouts_refuse_what_is_not_built(roll_lib):
    """A box without gaps (BoxDDP's rollout) at nl 3 and 7, and box tables at
    nl 7, raise before any launch and name the instances."""
    args = list(_roll_args(3, "sea_box_gaps", 4, torch.float64))
    before = dict(build.LAUNCHES)
    with pytest.raises(NotImplementedError,
                       match="no kernel instance for nl=3 sea box; its instances: .*"
                             "nl=3 sea gaps, nl=3 sea, nl=3 sea box gaps"):
        vsa_kernels.rollout2(*args[:11])
    seven = list(_roll_args(7, "sea_box_gaps", 4, torch.float64))
    with pytest.raises(NotImplementedError, match="no kernel instance for nl=7 sea box;"):
        vsa_kernels.rollout1(*_k6_args(seven[:11]))
    lb, ub = (torch.tensor(np.tile(b, (5, 1))) for b in ([-1.0] * 7, [1.0] * 7))
    seven[0] = seven[0]._replace(lb=lb.numpy(), ub=ub.numpy())
    seven[9], seven[10] = lb, ub
    with pytest.raises(NotImplementedError,
                       match="no kernel instance for nl=7 sea box tables gaps;"):
        vsa_kernels.rollout2(*seven)
    with pytest.raises(NotImplementedError, match="nl=7 sea box; its instances"):
        build.launch_of("rollout2", torch.float64, 1024, variant="sea box")
    assert build.LAUNCHES == before
