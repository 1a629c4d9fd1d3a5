"""The group kernel of ``csrc/riccati_box.cu`` (K2 and K5 with BoxQP gains,
K4 with Cholesky gains) run on the CPU.

The CUDA source compiles with g++ against the stand-ins of
``tests/cuda_on_cpu``: one thread per CUDA thread, __syncthreads at a
barrier over the block and the warp primitives at one over the warp, cp.async as a copy, and shared
memory refilled with NaN bytes before each block, so an unstaged read
shows. The wrappers, pointed at that library, are held against their plain
versions on ragged batches (one 16-scenario block and a partial one; B=15
and B=33 take the one-element copies, B=40 the 16-byte ones), K2 and K5
warm and cold, K4 at nu 2 (the SEA arm) and 4 (the VSA arm), with lanes at
a negative reg and one NaN scenario; K4 also at the 3- and 7-DoF SEA arms'
shapes (12, 3) and (28, 7), the latter in its wide layout (a
scenario's knot a tile of its own, 4 scenarios a block) at B=1, 5, 15 and
with one NaN scenario in its block, and its launch; K2 and K5 with [T, nu]
box tables (rows all
different, one knot pinched) at B=1, 15 and 200, and with tables of equal
rows against the shared box; K4 at (8, 2) on the double pendulum's data
(T=10, a zero Fu column, Luu[1, 1] zero, an indefinite terminal Lxx) at
B=1, 15 and 200. That checks the
group mapping, the exchanges, the staging and the ragged block without a
card.

The kernel performs its plain version's operations in the same order, so
the two agree to the bit, flags and NaNs included, in f64 and f32: the
kernel builds with -ffp-contract=off, and the plain versions run here with
a correctly rounded square root (``torch.sqrt`` on the CPU is not, for
longer tensors).
"""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest
import torch

from aslr_to_tpu_torch import seven_dof_sea, three_dof_sea, two_dof_sea, two_dof_vsa_boxddp
from aslr_to_tpu_torch.kernels import build, riccati, vsa_kernels
from cuda_on_cpu.gxx import gxx_library, ieee_sqrt
from cuda_on_cpu.pendulum import pendulum_k4_inputs, zero_column_kept
from cuda_on_cpu.tables import box_tables

T = 6


@pytest.fixture(scope="module")
def box_lib(tmp_path_factory):
    """riccati_box.cu built for the CPU; the wrappers launch it on CPU
    tensors while the fixture lasts."""
    handle = gxx_library(tmp_path_factory.mktemp("box_kernel"), ["riccati_box.cu"],
                         "sweep_smem", ["aslr_riccati_box", "aslr_riccati_fddp",
                                        "aslr_riccati_fddp_n7_launch"])
    mp = pytest.MonkeyPatch()
    mp.setattr(build, "_lib", handle)
    mp.setattr(riccati, "_route", lambda t: "kernel")
    mp.setattr(build, "stream_of", lambda t: None)
    mp.setattr(torch, "sqrt", ieee_sqrt)
    yield handle
    mp.undo()


def _args(kernel, nu, B, warm, dtype, seed=0):
    """K2 (VSA, nu 4), K5 (VSA nu 4, or the SEA arm, nu 2, in a box) or K4
    (the same arms, no box) on a random trajectory with gaps; every tenth
    lane at a negative reg."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=dtype)

    xs = t(0.3 * rng.standard_normal((T + 1, 8, B)))
    if nu == 4:
        w = two_dof_vsa_boxddp(T=T, dtype=dtype, device="cpu")
        spec = vsa_kernels.extract_vsa_spec(w.problem, w.bounds)
        us = t(np.concatenate([3.0 * rng.standard_normal((T, 2, B)),
                               2.0 * np.abs(rng.standard_normal((T, 2, B)))], axis=1))
        lb, ub = spec.lb, spec.ub
    else:
        spec = vsa_kernels.extract_vsa_spec(two_dof_sea(T=T, dtype=dtype, device="cpu").problem,
                                            None)
        us = t(3.0 * rng.standard_normal((T, 2, B)))
        lb, ub = np.array([-2.0, -1.5]), np.array([1.0, 2.5])
    lin = vsa_kernels.linearize_plain(spec, xs, us, torch.full((B,), spec.w_goal_term,
                                                                dtype=dtype))
    r = lin.run
    derivs = (r["Fx"], r["Fu"], r["Lx"], r["Lu"], r["Lxx"], r["Lxu"], r["Luu"], lin.term["Lx"],
              lin.term["Lxx"])
    box = [t(np.repeat(np.asarray(b, dtype=float)[:, None], B, axis=1)) for b in (lb, ub)]
    kprev = t(0.5 * rng.standard_normal((T, nu, B))) if warm else None
    reg = t(np.where(np.arange(B) % 10 == 0, -0.05, 1e-9))
    tail = (us, kprev, box[0], box[1], reg, 2 if warm else 6)
    if kernel == "riccati_box":
        return riccati.riccati_box_backward, riccati.riccati_box_plain, derivs + tail
    fs = torch.cat([torch.full_like(xs[:1], 0.01), lin.xnext - xs[1:]], dim=0)
    if kernel == "riccati_fddp":
        return riccati.riccati_fddp_backward, riccati.riccati_fddp_plain, derivs + (fs, reg)
    return riccati.riccati_boxfddp_backward, riccati.riccati_boxfddp_plain, derivs + (fs,) + tail


def _assert_same_bits(got, want):
    for name, g, w in zip(want._fields, got, want):
        assert torch.equal(g.isnan(), w.isnan()), name
        assert torch.equal(g.nan_to_num(0.0), w.nan_to_num(0.0)), name


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("batch", [15, 33, 40])
@pytest.mark.parametrize("kernel,nu", [("riccati_box", 4), ("riccati_boxfddp", 4),
                                       ("riccati_boxfddp", 2)])
def test_box_kernel_on_cpu_matches_plain_version(box_lib, kernel, nu, batch, warm, dtype):
    fn, plain, args = _args(kernel, nu, batch, warm, dtype)
    before = build.LAUNCHES[kernel]
    got = fn(*args)
    assert build.LAUNCHES[kernel] == before + 1
    _assert_same_bits(got, plain(*args))
    assert not bool(got.ok.all()) and bool(got.ok.any())
    assert bool(got.retryable.any()) and not bool(got.retryable.all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("batch", [15, 33, 40])
@pytest.mark.parametrize("nu", [2, 4])
def test_fddp_kernel_on_cpu_matches_plain_version(box_lib, nu, batch, dtype):
    """K4, the Cholesky instance of the group kernel, at the SEA (nu 2) and
    VSA (nu 4) shapes."""
    fn, plain, args = _args("riccati_fddp", nu, batch, False, dtype)
    before = build.LAUNCHES["riccati_fddp"]
    got = fn(*args)
    assert build.LAUNCHES["riccati_fddp"] == before + 1
    _assert_same_bits(got, plain(*args))
    assert not bool(got.ok.all()) and bool(got.ok.any())
    assert bool(got.retryable.any()) and not bool(got.retryable.all())


@pytest.mark.parametrize("kernel", ["riccati_box", "riccati_boxfddp", "riccati_fddp"])
def test_box_kernel_on_cpu_keeps_a_scenario_in_its_group(box_lib, kernel):
    """Scenario 25's inputs NaN: it fails alone; the other scenarios of its
    warp (24, 26, 27) keep ok and equal the plain version."""
    fn, plain, args = _args(kernel, 4, 40, True, torch.float64)
    args = list(args)
    for i in range(9):
        args[i] = args[i].clone()
        args[i][..., 25] = float("nan")
    got = fn(*args)
    _assert_same_bits(got, plain(*args))
    assert not bool(got.ok[25]) and bool(got.ok[[24, 26, 27]].all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("batch", [1, 15, 200])
def test_fddp_kernel_on_cpu_matches_plain_on_the_double_pendulum(box_lib, batch, dtype):
    """K4 at (8, 2) on the double pendulum's data (T=10, the sweep shorter
    than any other path's; ``cuda_on_cpu/pendulum.py``): a zero Fu column,
    Luu[1, 1] zero, an indefinite terminal Lxx, lanes that fail to factor
    among lanes that do, a ragged last block. To the bit against the plain
    version, flags included; k[:, 1] and K[:, 1] exactly zero where a lane
    factors, so no failed lane's NaN reached them."""
    args = pendulum_k4_inputs(batch, dtype)
    Fu, Luu, tLxx = args[1], args[6], args[8]
    assert bool((Fu[:, :, 1] == 0).all()) and bool((Luu[:, 1, 1] == 0).all())
    assert bool((torch.linalg.eigvalsh(tLxx.permute(2, 0, 1).double())[:, 0] < 0).any())
    before = build.LAUNCHES["riccati_fddp"]
    got = riccati.riccati_fddp_backward(*args)
    assert build.LAUNCHES["riccati_fddp"] == before + 1
    want = riccati.riccati_fddp_plain(*args)
    _assert_same_bits(got, want)
    assert zero_column_kept(got) and zero_column_kept(want)
    assert not bool(got.ok[0])          # lane 0 at a negative reg
    if batch > 1:
        assert bool(got.ok.any()) and bool(got.retryable.any())


def _ndof_args(nl, B, dtype, T_, seed=0):
    """K4 on the 3- or 7-DoF SEA arm: the derivatives of a random trajectory
    with gaps; every tenth lane at a negative reg."""
    rng = np.random.default_rng(seed)

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
    return (r["Fx"], r["Fu"], r["Lx"], r["Lu"], r["Lxx"], r["Lxu"], r["Luu"], lin.term["Lx"],
            lin.term["Lxx"], fs, reg)


@pytest.mark.parametrize("nl,batch,dtype", [
    (3, 15, torch.float64), (3, 33, torch.float64), (3, 40, torch.float64),
    (3, 40, torch.float32), (7, 9, torch.float64), (7, 9, torch.float32)],
    ids=lambda v: str(v).replace("torch.", ""))
def test_ndof_fddp_kernel_on_cpu_matches_plain_version(box_lib, nl, batch, dtype):
    """K4 at (ndx, nu) = (12, 3) (16 lanes a scenario, T=6) and (28, 7) (a
    warp a scenario, T=4; one stage of shared memory in f64, two in f32):
    the lanes past ndx own no row and meet every exchange."""
    args = _ndof_args(nl, batch, dtype, 6 if nl == 3 else 4)
    before = build.LAUNCHES["riccati_fddp"]
    got = riccati.riccati_fddp_backward(*args)
    assert build.LAUNCHES["riccati_fddp"] == before + 1
    _assert_same_bits(got, riccati.riccati_fddp_plain(*args))
    assert not bool(got.ok.all()) and bool(got.ok.any())
    assert bool(got.retryable.any()) and not bool(got.retryable.all())


def test_ndof_fddp_kernel_on_cpu_keeps_a_scenario_in_its_group(box_lib):
    """K4 at (12, 3) with scenario 9's inputs NaN: it fails alone; the other
    scenarios of its warp (8, 10, 11: two in a warp at 16 lanes) keep ok."""
    args = list(_ndof_args(3, 33, torch.float64, 6))
    for i in range(9):
        args[i] = args[i].clone()
        args[i][..., 9] = float("nan")
    got = riccati.riccati_fddp_backward(*args)
    _assert_same_bits(got, riccati.riccati_fddp_plain(*args))
    assert not bool(got.ok[9]) and bool(got.ok[[8, 11, 12, 13]].all())


def test_fddp_kernel_refuses_a_shape_it_has_no_instance_for(box_lib):
    """(ndx, nu) = (12, 6) has no instance: the wrapper raises before any
    launch and names the instances there are."""
    args = list(_ndof_args(3, 4, torch.float64, 6))
    T_, B = 6, 4
    args[1] = torch.zeros((T_, 12, 6, B), dtype=torch.float64)
    args[3] = torch.zeros((T_, 6, B), dtype=torch.float64)
    args[5] = torch.zeros((T_, 12, 6, B), dtype=torch.float64)
    args[6] = torch.zeros((T_, 6, 6, B), dtype=torch.float64)
    before = build.LAUNCHES["riccati_fddp"]
    with pytest.raises(NotImplementedError,
                       match="ndx=12 nu=6; its instances: ndx=8 nu=2, ndx=8 nu=4, ndx=12 nu=3"):
        riccati.riccati_fddp_backward(*args)
    assert build.LAUNCHES["riccati_fddp"] == before


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("batch", [1, 15, 200])
@pytest.mark.parametrize("kernel,nu,warm", [("riccati_box", 4, True), ("riccati_boxfddp", 4, False),
                                            ("riccati_boxfddp", 2, True)])
def test_box_kernel_on_cpu_reads_the_box_tables(box_lib, kernel, nu, warm, batch, dtype):
    """K2 and K5 with [T, nu] box tables (rows all different, knot 3's
    torques pinched): knot t's QP reads row t, staged with knot t's inputs;
    equal to the plain version to the bit, and the pinched knot clamps."""
    fn, plain, args = _args(kernel, nu, batch, warm, dtype)
    args = list(args)
    n = len(args)
    args[n - 4], args[n - 3] = box_tables(T, nu, dtype, pinch=3)
    got = fn(*args, per_knot_box=True)
    _assert_same_bits(got, plain(*args, per_knot_box=True))
    us = args[n - 6]
    u3 = us[3, :2] - got.k[3, :2]
    assert bool(((u3 - 0.05).abs() < 1e-6).any() | ((u3 + 0.05).abs() < 1e-6).any())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kernel,nu", [("riccati_box", 4), ("riccati_boxfddp", 4),
                                       ("riccati_boxfddp", 2)])
def test_box_kernel_on_cpu_equal_rows_give_the_shared_bits(box_lib, kernel, nu, dtype):
    """Tables whose rows are all the shared box give the shared route's
    bits, kernel against kernel."""
    fn, _, args = _args(kernel, nu, 40, True, dtype)
    args = list(args)
    n = len(args)
    shared = fn(*args)
    args[n - 4], args[n - 3] = (b[:, 0][None].expand(T, nu).contiguous()
                                for b in (args[n - 4], args[n - 3]))
    _assert_same_bits(fn(*args, per_knot_box=True), shared)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("batch", [1, 5, 15])
def test_wide_fddp_kernel_on_cpu_matches_plain_version(box_lib, batch, dtype):
    """K4 at (28, 7) in its wide layout (each scenario's knot staged as a
    tile of its own by element copies, rows read 16 bytes a load, two
    stages in f64 too; 4 scenarios a block, so B=1, 5 and 15 end in a
    partial block) at T=5 equals its plain version to the bit."""
    args = _ndof_args(7, batch, dtype, 5, seed=2)
    before = build.LAUNCHES["riccati_fddp"]
    got = riccati.riccati_fddp_backward(*args)
    assert build.LAUNCHES["riccati_fddp"] == before + 1
    _assert_same_bits(got, riccati.riccati_fddp_plain(*args))
    if batch > 1:       # lane 0 (and 10) at a negative reg
        assert not bool(got.ok.all()) and bool(got.ok.any())
        assert bool(got.retryable.any()) and not bool(got.retryable.all())


def test_wide_fddp_kernel_on_cpu_keeps_a_scenario_in_its_group(box_lib):
    """K4 at (28, 7) with scenario 5's inputs NaN: it fails alone; the other
    scenarios of its block (4, 6, 7) keep ok and equal the plain version."""
    args = list(_ndof_args(7, 9, torch.float64, 4))
    for i in range(9):
        args[i] = args[i].clone()
        args[i][..., 5] = float("nan")
    got = riccati.riccati_fddp_backward(*args)
    _assert_same_bits(got, riccati.riccati_fddp_plain(*args))
    assert not bool(got.ok[5]) and bool(got.ok[[4, 6, 7]].all())


@pytest.mark.parametrize("dtype,smem", [(torch.float32, 96896), (torch.float64, 193472)],
                         ids=["f32", "f64"])
def test_wide_fddp_launch_on_cpu(box_lib, dtype, smem):
    """At B=1024, K4 at (28, 7) runs 256 blocks of 128 threads (a warp a
    scenario), and two stages and the scratch of a block take 96,896 bytes
    in f32 (two blocks fit an SM's 228 KB) and 193,472 in f64 (two stages
    within a block's 227 KB)."""
    info = build.launch_of("riccati_fddp", dtype, 1024)
    assert (info["grid"], info["threads"], info["smem"]) == (256, 128, smem)

