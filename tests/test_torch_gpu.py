"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA
device; the decision is taken inside a fixture, so every worker collects
the same tests. The file imports no JAX, so it also runs on a machine
without it. K1-K3 run on the VSA arm and again in their SEA and gap
variants; K4 on the SEA arm with gaps; the box kernel (K2, and K5 at nu 4
and 2) on ragged batches, warm and cold, and with one NaN scenario among
healthy ones in its warp; K6 in its box,
SEA-gap and unbounded variants, also against K3's first trial; K3 and K6
in every variant on ragged batches, to the bit; K1 (VSA, SEA) and K4 (nu 2
and 4) on ragged batches to the bit, and K4 with one NaN scenario in its
warp; K1, K4, K3 and K6 at the 3- and 7-DoF SEA arms' instances on ragged
batches to the bit, and the launchers' refusal of a shape they are not
built for; the fast path of the per-scenario solver against its plain
backend; the per-knot table variants of K1, K2, K5, K3 and K6 on ragged
batches to the bit (K1, K3 and K6 also at the 3- and 7-DoF arms), and
tables of equal rows against the shared route; K6 at nl 7 and K4 at
(28, 7) in their wide layouts with one NaN scenario among B=15 and 200,
and their launches on the card (K6's grid fills the SMs at B=1024, two
blocks of K4 fit an SM in f32); K1 at nl 7 and K3 at nl 7 in the layout
its batch picks (wide to B=1024, general at 4096), shared and with a
target table, on ragged batches and with one NaN scenario, and K3's
launch at both batches; the staged homotopy with the diverged-lane
rescue against its plain backend in f64, and the rescue keeping the lanes
it does not take to the bit; K4 on the double pendulum's data (T=10) to
the bit at B=1, 15, 200 and 4096, and the pendulum's generic route through
K4 against the generic sweep in f64, and its line search's two forms (all
step lengths at once, one a round) against each other; K5 at (12, 3) and
(28, 7) and K3 and K6 at nl 3 and 7 without box or gaps and with a box and
gaps on ragged batches to the bit, their launches, the refusals of K2
above ndx 8, a box without gaps and box tables at n-DoF, and the 7-DoF
BoxFDDP and DDP solves on the lane and fast routes against their plain
backends; K5 at (28, 7) (its BoxQP spread over the warp) in a binding box,
one that clamps every control and one that clamps none, warm and cold, at
B=1, 15 and 200 to the bit, one scenario with a non-finite Quu failing
alone, and its launch; P against its plain version:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: float64 outputs agree with the plain version to a normwise
relative error of 1e-9 per tensor and lane, with flags equal; the kernels
are built with ``-fmad=false`` and follow the plain versions' order of
operations, so in practice they agree to the bit. float32 outputs are held
to 1e-5: the rollout amplifies any rounding difference over the knots.
"""
import numpy as np
import pytest
import torch

from aslr_to_tpu_torch import SolverSettings, make_batched_solver, seven_dof_sea, three_dof_sea
from aslr_to_tpu_torch import two_dof_sea, two_dof_vsa_boxddp
from aslr_to_tpu_torch import probe
from aslr_to_tpu_torch.kernels import build, riccati, vsa_kernels
from cuda_on_cpu.tables import box_tables, per_knot_target

pytestmark = pytest.mark.gpu

T, B = 12, 200          # B not a multiple of the 128-thread block: ragged edge
TOL = {torch.float64: 1e-9, torch.float32: 1e-5}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, want):
    """Max over lanes (last axis) of max|got - want| / max|want| in the lane."""
    got, want = got.double(), want.double()
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    d = torch.nan_to_num(got - want).abs().reshape(-1, got.shape[-1]).amax(0)
    scale = torch.nan_to_num(want).abs().reshape(-1, want.shape[-1]).amax(0)
    return float(torch.where(d > 0, d / scale.clamp_min(1e-300), 0.0).max())


def _assert_same(got, want, dtype):
    for name, (g, w) in zip(want._fields, zip(got, want)):
        if isinstance(w, dict):
            for key in w:
                assert _rel_err(g[key], w[key]) <= TOL[dtype], f"{name}.{key}"
        elif w.dtype == torch.bool:
            assert torch.equal(g, w), name
        else:
            assert _rel_err(g, w) <= TOL[dtype], name


def _inputs(dtype, device, seed=0, B=B):
    w = two_dof_vsa_boxddp(T=T, dtype=dtype, device=device)
    spec = vsa_kernels.extract_vsa_spec(w.problem, w.bounds)
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    xs = t(0.3 * rng.standard_normal((T + 1, 8, B)))
    us = t(np.concatenate([3.0 * rng.standard_normal((T, 2, B)),
                           2.0 * np.abs(rng.standard_normal((T, 2, B)))], axis=1))
    box = [t(np.repeat(b[:, None], B, axis=1)) for b in (spec.lb, spec.ub)]
    return dict(spec=spec, xs=xs, us=us, lb=box[0], ub=box[1],
                wterm=torch.full((B,), spec.w_goal_term, dtype=dtype, device=device),
                kprev=t(0.5 * rng.standard_normal((T, 4, B))),
                reg=t(np.where(np.arange(B) % 10 == 0, -0.05, 1e-9)),
                alpha_a=t(np.ones(B)), alpha_b=t(0.5 ** (1 + np.arange(B) % 4)))


def _bw_args(inp, lin):
    r = lin.run
    return (r["Fx"], r["Fu"], r["Lx"], r["Lu"], r["Lxx"], r["Lxu"], r["Luu"],
            lin.term["Lx"], lin.term["Lxx"], inp["us"], inp["kprev"], inp["lb"],
            inp["ub"], inp["reg"], 2)


def _roll_args(inp, bw):
    return (inp["spec"], inp["xs"], inp["us"], bw.k, bw.K, inp["xs"][0].contiguous(),
            inp["alpha_a"], inp["alpha_b"], inp["wterm"], inp["lb"], inp["ub"])


def _calls(name, inp):
    """(kernel wrapper, plain version, args) of one kernel on ``inp``."""
    lin = vsa_kernels.linearize_plain(inp["spec"], inp["xs"], inp["us"], inp["wterm"])
    if name == "linearize":
        return (vsa_kernels.linearize, vsa_kernels.linearize_plain,
                (inp["spec"], inp["xs"], inp["us"], inp["wterm"]))
    bw_args = _bw_args(inp, lin)
    if name == "riccati_box":
        return riccati.riccati_box_backward, riccati.riccati_box_plain, bw_args
    if name == "riccati_boxfddp":
        fs = _gaps(inp, lin)
        return (riccati.riccati_boxfddp_backward, riccati.riccati_boxfddp_plain,
                bw_args[:9] + (fs,) + bw_args[9:])
    return (vsa_kernels.rollout2, vsa_kernels.rollout2_plain,
            _roll_args(inp, riccati.riccati_box_plain(*bw_args)))


def _gaps(inp, lin):
    xs = inp["xs"]
    x0 = xs[0] + 0.01 * torch.ones_like(xs[0])
    return torch.cat([(x0 - xs[0])[None], lin.xnext - xs[1:]], dim=0)


def _sea_calls(name, dtype, device, B=B):
    """K1's SEA variant, K4 with gaps and K3's gap variant on the SEA arm."""
    w = two_dof_sea(T=T, dtype=dtype, device=device)
    spec = vsa_kernels.extract_vsa_spec(w.problem, None)
    rng = np.random.default_rng(1)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    xs, us = t(0.3 * rng.standard_normal((T + 1, 8, B))), t(3.0 * rng.standard_normal((T, 2, B)))
    wterm = torch.full((B,), spec.w_goal_term, dtype=dtype, device=device)
    if name == "linearize":
        return vsa_kernels.linearize, vsa_kernels.linearize_plain, (spec, xs, us, wterm)
    lin = vsa_kernels.linearize_plain(spec, xs, us, wterm)
    r = lin.run
    fs = _gaps(dict(xs=xs), lin)
    reg = t(np.where(np.arange(B) % 10 == 0, -5.0, 1e-9))
    bw_args = (r["Fx"], r["Fu"], r["Lx"], r["Lu"], r["Lxx"], r["Lxu"], r["Luu"],
               lin.term["Lx"], lin.term["Lxx"], fs, reg)
    if name == "riccati_fddp":
        return riccati.riccati_fddp_backward, riccati.riccati_fddp_plain, bw_args
    bw = riccati.riccati_fddp_plain(*bw_args)
    k, K = torch.where(bw.ok, bw.k, 0.0), torch.where(bw.ok, bw.K, 0.0)
    infeas = (torch.arange(B, device=device) % 2).to(dtype)
    ones = torch.ones(B, dtype=dtype, device=device)
    return (vsa_kernels.rollout2, vsa_kernels.rollout2_plain,
            (spec, xs, us, k, K, xs[0].contiguous(), ones, 0.5 * ones, wterm, None, None,
             fs, infeas))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", ["linearize", "riccati_box", "rollout2"])
def test_kernel_matches_plain_version(cuda, name, dtype):
    kernel, plain, args = _calls(name, _inputs(dtype, cuda))
    before = build.LAUNCHES[name]
    got = kernel(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == before + 1
    want = plain(*args)
    if name == "rollout2":
        for g, w in zip(got, want):
            _assert_same(g, w, dtype)
    else:
        _assert_same(got, want, dtype)
    if name == "riccati_box":
        assert not bool(got.ok.all()) and bool(got.ok.any())   # the negative-reg lanes fail


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", ["linearize", "riccati_fddp", "rollout2"])
def test_sea_kernel_matches_plain_version(cuda, name, dtype):
    """K1's SEA variant, K4 on the SEA shape with gaps, K3 with gaps."""
    kernel, plain, args = _sea_calls(name, dtype, cuda)
    launched = "riccati_fddp" if name == "riccati_fddp" else name
    before = build.LAUNCHES[launched]
    got = kernel(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES[launched] == before + 1
    want = plain(*args)
    if name == "rollout2":
        for g, w in zip(got, want):
            _assert_same(g, w, dtype)
    else:
        _assert_same(got, want, dtype)
    if name == "riccati_fddp":
        assert not bool(got.ok.all()) and bool(got.ok.any())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_boxfddp_kernel_matches_plain_version(cuda, dtype):
    """K5 on the VSA shape, warm from kprev, with gaps."""
    kernel, plain, args = _calls("riccati_boxfddp", _inputs(dtype, cuda))
    before = build.LAUNCHES["riccati_boxfddp"]
    got = kernel(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES["riccati_boxfddp"] == before + 1
    _assert_same(got, plain(*args), dtype)
    assert not bool(got.ok.all()) and bool(got.ok.any())


def test_fddp_lane_solver_kernels_match_plain_on_card(cuda):
    w = two_dof_sea(T=T, dtype=torch.float64, device=cuda)
    settings = SolverSettings(maxiter=8, th_stop=1e-5)
    g = torch.Generator(device=cuda).manual_seed(0)
    x0s = 0.05 * torch.randn(64, 8, generator=g, device=cuda, dtype=torch.float64)
    res = {}
    for backend in ("auto", "plain"):
        solve = make_batched_solver(w.problem, settings, use_gaps=True, bounds=None,
                                    warm_start=True, use_fast_path="lanes", backend=backend)
        build.reset_launches()
        res[backend] = solve(x0s)
        assert (build.LAUNCHES["riccati_fddp"] > 0) == (backend == "auto"), backend
    k, p = res["auto"], res["plain"]
    assert torch.equal(k.iterations, p.iterations)
    assert torch.equal(k.converged, p.converged) and torch.equal(k.diverged, p.diverged)
    torch.testing.assert_close(k.cost, p.cost, rtol=1e-8, atol=0)
    torch.testing.assert_close(k.us, p.us, rtol=0, atol=1e-8)


def test_lane_solver_kernels_match_plain_on_card(cuda):
    w = two_dof_vsa_boxddp(T=T, dtype=torch.float64, device=cuda)
    settings = SolverSettings(maxiter=8, th_stop=1e-5, boxqp_warm_iters=2)
    g = torch.Generator(device=cuda).manual_seed(0)
    x0s = 0.05 * torch.randn(64, 8, generator=g, device=cuda, dtype=torch.float64)
    res = {}
    for backend in ("auto", "plain"):
        solve = make_batched_solver(w.problem, settings, use_gaps=False, bounds=w.bounds,
                                    use_fast_path="lanes", backend=backend)
        build.reset_launches()
        res[backend] = solve(x0s)
        launched = sum(build.LAUNCHES.values())
        assert (launched > 0) == (backend == "auto"), backend
    k, p = res["auto"], res["plain"]
    assert torch.equal(k.iterations, p.iterations)
    assert torch.equal(k.converged, p.converged) and torch.equal(k.diverged, p.diverged)
    torch.testing.assert_close(k.cost, p.cost, rtol=1e-8, atol=0)
    torch.testing.assert_close(k.us, p.us, rtol=0, atol=1e-8)


def _box_args(kernel, nu, dtype, device, B, warm):
    """K2 (VSA, nu 4) or K5 (VSA nu 4, or the SEA arm, nu 2, in a made-up
    box) on a random trajectory with gaps; a tenth of the lanes at a
    negative reg. Returns (kernel wrapper, plain version, args)."""
    if nu == 4:
        inp = _inputs(dtype, device, B=B)
        spec, xs, us, kprev = inp["spec"], inp["xs"], inp["us"], inp["kprev"]
        lb, ub, reg = inp["lb"], inp["ub"], inp["reg"]
    else:
        spec = vsa_kernels.extract_vsa_spec(two_dof_sea(T=T, dtype=dtype, device=device).problem,
                                            None)
        rng = np.random.default_rng(2)

        def t(a):
            return torch.tensor(a, dtype=dtype, device=device)

        xs = t(0.3 * rng.standard_normal((T + 1, 8, B)))
        us, kprev = t(3.0 * rng.standard_normal((T, 2, B))), t(rng.standard_normal((T, 2, B)))
        lb, ub = t(np.full((2, B), -2.0)), t(np.full((2, B), 2.5))
        reg = t(np.where(np.arange(B) % 10 == 0, -0.05, 1e-9))
    wterm = torch.full((B,), spec.w_goal_term, dtype=dtype, device=device)
    lin = vsa_kernels.linearize_plain(spec, xs, us, wterm)
    r = lin.run
    derivs = (r["Fx"], r["Fu"], r["Lx"], r["Lu"], r["Lxx"], r["Lxu"], r["Luu"], lin.term["Lx"],
              lin.term["Lxx"])
    box = (us, kprev if warm else None, lb, ub, reg, 2 if warm else 6)
    if kernel == "riccati_box":
        return riccati.riccati_box_backward, riccati.riccati_box_plain, derivs + box
    return (riccati.riccati_boxfddp_backward, riccati.riccati_boxfddp_plain,
            derivs + (_gaps(dict(xs=xs), lin),) + box)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("batch", [1, 15, 200])
@pytest.mark.parametrize("kernel,nu", [("riccati_box", 4), ("riccati_boxfddp", 4),
                                       ("riccati_boxfddp", 2)])
def test_box_kernel_matches_plain_version(cuda, kernel, nu, batch, warm, dtype):
    """The box kernel (K2, and K5 at nu 4 and 2) on ragged batches (none a
    multiple of the 16 scenarios of a block; B=15 also takes the
    one-element copies), warm from kprev and cold."""
    fn, plain, args = _box_args(kernel, nu, dtype, cuda, batch, warm)
    before = build.LAUNCHES[kernel]
    got = fn(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES[kernel] == before + 1
    _assert_same(got, plain(*args), dtype)
    if batch > 1:       # lanes 0 and 10 at a negative reg: the flags go both ways
        assert not bool(got.ok.all()) and bool(got.ok.any())
        assert bool(got.retryable.any()) and not bool(got.retryable.all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kernel", ["riccati_box", "riccati_boxfddp"])
def test_box_kernel_keeps_a_scenario_in_its_group(cuda, kernel, dtype):
    """A scenario whose inputs are NaN fails alone: the other scenarios of
    its warp (four a warp, eight lanes each) keep ok and equal the plain
    version."""
    fn, plain, args = _box_args(kernel, 4, dtype, cuda, B, True)
    args = list(args)
    for i in range(9):                  # the derivatives of scenario 25: warp 6, group 1
        args[i] = args[i].clone()
        args[i][..., 25] = float("nan")
    got, want = fn(*args), plain(*args)
    torch.cuda.synchronize()
    _assert_same(got, want, dtype)
    assert not bool(got.ok[25])
    assert bool(got.ok[[24, 26, 27]].all())


def _rollout1_args(variant, dtype, device):
    """K6's inputs in the box (VSA), SEA-gap and unbounded (VSA) variants."""
    if variant == "sea_gaps":
        kernel, plain, args = _sea_calls("rollout2", dtype, device)
        return args[:6] + (args[6],) + args[8:]
    inp = _inputs(dtype, device)
    args = _roll_args(inp, riccati.riccati_box_plain(*_bw_args(inp, vsa_kernels.linearize_plain(
        inp["spec"], inp["xs"], inp["us"], inp["wterm"]))))
    args = args[:6] + (inp["alpha_b"],) + args[8:]
    if variant == "vsa_unbounded":
        args = args[:8] + (None, None)
    return args


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("variant", ["vsa_box", "sea_gaps", "vsa_unbounded"])
def test_rollout1_matches_plain_and_rollout2(cuda, variant, dtype):
    """K6 equals its plain version, and K3's first trial at the same alpha
    to the bit (the same per-thread code)."""
    args = _rollout1_args(variant, dtype, cuda)
    before = build.LAUNCHES["rollout1"]
    got = vsa_kernels.rollout1(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rollout1"] == before + 1
    _assert_same(got, vsa_kernels.rollout1_plain(*args), dtype)
    first, _ = vsa_kernels.rollout2(*args[:7], 0.5 * args[6], *args[7:])
    for g, w in zip(got, first):        # the negative-reg lanes are NaN in both
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(g.nan_to_num(0.0), w.nan_to_num(0.0))


def _rollout2_args(variant, dtype, device, B):
    """K3's inputs at batch ``B``: the VSA arm in its box, unbounded, and in
    its box with gaps; the SEA arm with gaps. The gains of a lane whose
    backward failed are zeroed, as the solvers' are."""
    if variant == "sea_gaps":
        return _sea_calls("rollout2", dtype, device, B)[2]
    inp = _inputs(dtype, device, B=B)
    lin = vsa_kernels.linearize_plain(inp["spec"], inp["xs"], inp["us"], inp["wterm"])
    bw = riccati.riccati_box_plain(*_bw_args(inp, lin))
    args = _roll_args(inp, bw._replace(k=torch.where(bw.ok, bw.k, 0.0),
                                       K=torch.where(bw.ok, bw.K, 0.0)))
    if variant == "vsa_unbounded":
        return args[:9] + (None, None)
    if variant == "vsa_box_gaps":
        return args + (_gaps(inp, lin), (torch.arange(B, device=device) % 2).to(dtype))
    return args


def _assert_same_bits(got, want):
    for name, g, w in zip(want._fields, got, want):
        assert torch.equal(g.isnan(), w.isnan()), name
        assert torch.equal(g.nan_to_num(0.0), w.nan_to_num(0.0)), name


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("batch", [1, 15, 200])
@pytest.mark.parametrize("variant", ["vsa_box", "vsa_unbounded", "vsa_box_gaps", "sea_gaps"])
def test_rollouts_match_plain_version_to_the_bit(cuda, variant, batch, dtype):
    """K3 and K6 on ragged batches (none a multiple of a block's 16 or 32
    trajectories; B=1 and 15 also take the one-element copies) equal their
    plain versions to the bit, and K6 equals K3's first trial."""
    args = _rollout2_args(variant, dtype, cuda, batch)
    k6_args = args[:6] + args[7:]
    before = dict(build.LAUNCHES)
    got = vsa_kernels.rollout2(*args)
    one = vsa_kernels.rollout1(*k6_args)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rollout2"] == before["rollout2"] + 1
    assert build.LAUNCHES["rollout1"] == before["rollout1"] + 1
    for g, w in zip(got, vsa_kernels.rollout2_plain(*args)):
        _assert_same_bits(g, w)
    _assert_same_bits(one, vsa_kernels.rollout1_plain(*k6_args))
    first, _ = vsa_kernels.rollout2(*k6_args[:7], 0.5 * k6_args[6], *k6_args[7:])
    _assert_same_bits(one, first)


def _k1_k4_args(case, dtype, device, B):
    """(kernel wrapper, plain version, args): K1 on the VSA or the SEA arm,
    K4 at nu 2 (the SEA arm) or nu 4 (the VSA arm) with gaps and a tenth of
    the lanes at a negative reg."""
    if case == "linearize_sea":
        return _sea_calls("linearize", dtype, device, B)
    if case == "riccati_fddp_nu2":
        return _sea_calls("riccati_fddp", dtype, device, B)
    inp = _inputs(dtype, device, B=B)
    args = (inp["spec"], inp["xs"], inp["us"], inp["wterm"])
    if case == "linearize_vsa":
        return vsa_kernels.linearize, vsa_kernels.linearize_plain, args
    lin = vsa_kernels.linearize_plain(*args)
    derivs = _bw_args(inp, lin)[:9]
    return (riccati.riccati_fddp_backward, riccati.riccati_fddp_plain,
            derivs + (_gaps(inp, lin), inp["reg"]))


def _tensors(out):
    """Every tensor of a kernel's output (a Linearization's dicts opened)."""
    for v in out:
        if isinstance(v, dict):
            yield from v.values()
        else:
            yield v


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("batch", [1, 15, 200])
@pytest.mark.parametrize("case", ["linearize_vsa", "linearize_sea", "riccati_fddp_nu2",
                                  "riccati_fddp_nu4"])
def test_linearize_and_fddp_match_plain_version_to_the_bit(cuda, case, batch, dtype):
    """K1 (a group of lanes a knot and scenario) and K4 (four scenarios a
    warp) on ragged batches equal their plain versions to the bit."""
    fn, plain, args = _k1_k4_args(case, dtype, cuda, batch)
    name = "linearize" if case.startswith("linearize") else "riccati_fddp"
    before = build.LAUNCHES[name]
    got = fn(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == before + 1
    for g, w in zip(_tensors(got), _tensors(plain(*args))):
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(g.nan_to_num(0.0), w.nan_to_num(0.0))
    if name == "riccati_fddp" and batch > 1:    # lanes 0 and 10 at a negative reg
        assert not bool(got.ok.all()) and bool(got.ok.any())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", ["riccati_fddp_nu2", "riccati_fddp_nu4"])
def test_fddp_kernel_keeps_a_scenario_in_its_group(cuda, case, dtype):
    """K4 with scenario 25's derivatives NaN: it fails alone, and the other
    scenarios of its warp (24, 26, 27) keep ok and equal the plain version."""
    fn, plain, args = _k1_k4_args(case, dtype, cuda, B)
    args = list(args)
    for i in range(9):
        args[i] = args[i].clone()
        args[i][..., 25] = float("nan")
    got, want = fn(*args), plain(*args)
    torch.cuda.synchronize()
    _assert_same_bits(got, want)
    assert not bool(got.ok[25])
    assert bool(got.ok[[24, 26, 27]].all())


def test_fast_path_kernels_match_plain_on_card(cuda):
    w = two_dof_vsa_boxddp(T=T, dtype=torch.float64, device=cuda)
    settings = SolverSettings(maxiter=8, th_stop=1e-5, boxqp_warm_iters=2)
    g = torch.Generator(device=cuda).manual_seed(0)
    x0s = 0.05 * torch.randn(64, 8, generator=g, device=cuda, dtype=torch.float64)
    res = {}
    for backend in ("auto", "plain"):
        solve = make_batched_solver(w.problem, settings, use_gaps=False, bounds=w.bounds,
                                    use_fast_path=True, backend=backend)
        build.reset_launches()
        res[backend] = solve(x0s)
        launched = (build.LAUNCHES["rollout1"] > 0 and build.LAUNCHES["linearize"] > 0
                    and build.LAUNCHES["riccati_box"] > 0)
        assert launched == (backend == "auto"), backend
        assert build.LAUNCHES["rollout2"] == 0
    k, p = res["auto"], res["plain"]
    assert torch.equal(k.iterations, p.iterations)
    assert torch.equal(k.converged, p.converged) and torch.equal(k.diverged, p.diverged)
    torch.testing.assert_close(k.cost, p.cost, rtol=1e-8, atol=0)
    torch.testing.assert_close(k.us, p.us, rtol=0, atol=1e-8)


@pytest.mark.parametrize("ilp", probe.ILPS)
def test_probe_matches_plain(cuda, ilp):
    """P's mul+add mode equals its plain version to the bit; its fma mode
    is within 1e-6 of the float64-evaluated plain fma (double rounding)."""
    x = probe.inputs(5000)
    for fma in (False, True):
        before = build.LAUNCHES["probe"]
        got = probe.probe(x, ilp, fma, chain=40, loop=3)
        torch.cuda.synchronize()
        assert build.LAUNCHES["probe"] == before + 1
        want = probe.probe_plain(x, ilp, fma, chain=40, loop=3)
        if fma:
            assert float(((got - want).abs() / want.abs()).max()) <= 1e-6
        else:
            assert torch.equal(got, want)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    inp = _inputs(torch.float64, cuda)
    spec, xs, us, wterm = inp["spec"], inp["xs"], inp["us"], inp["wterm"]
    with pytest.raises(ValueError, match="contiguous"):
        vsa_kernels.linearize(spec, xs, us.transpose(0, 1).contiguous().transpose(0, 1),
                              wterm)
    with pytest.raises(ValueError, match="shape"):
        vsa_kernels.linearize(spec, xs, us[:, :, :-1].contiguous(), wterm)
    with pytest.raises(TypeError, match="float32 or float64"):
        vsa_kernels.linearize(spec, xs.half(), us.half(), wterm.half())


def _ndof_inputs(nl, dtype, device, B, seed=0):
    """The 3- or 7-DoF SEA arm: (spec, xs, us, wterm, the derivatives of
    the linearization, fs, reg with every tenth lane negative)."""
    w = (three_dof_sea if nl == 3 else seven_dof_sea)(T=T, dtype=dtype, device=device)
    spec = vsa_kernels.extract_vsa_spec(w.problem, None)
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    xs = t(0.3 * rng.standard_normal((T + 1, 4 * nl, B)))
    us = t(3.0 * rng.standard_normal((T, nl, B)))
    wterm = torch.full((B,), spec.w_goal_term, dtype=dtype, device=device)
    lin = vsa_kernels.linearize_plain(spec, xs, us, wterm)
    r = lin.run
    derivs = (r["Fx"], r["Fu"], r["Lx"], r["Lu"], r["Lxx"], r["Lxu"], r["Luu"], lin.term["Lx"],
              lin.term["Lxx"])
    fs = torch.cat([torch.full_like(xs[:1], 0.01), lin.xnext - xs[1:]], dim=0)
    reg = t(np.where(np.arange(B) % 10 == 0, -0.05, 1e-9))
    return spec, xs, us, wterm, derivs, fs, reg


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("batch", [1, 15, 200])
@pytest.mark.parametrize("nl", [3, 7])
def test_ndof_kernels_match_plain_version_to_the_bit(cuda, nl, batch, dtype):
    """K1, K4, K3 and K6 at the 3- and 7-DoF SEA arms' instances (nl 3 and
    7; K4 at (12, 3) and (28, 7), the rollouts unboxed with gaps) on ragged
    batches equal their plain versions to the bit, and K6 equals K3's first
    trial."""
    spec, xs, us, wterm, derivs, fs, reg = _ndof_inputs(nl, dtype, cuda, batch)
    before = dict(build.LAUNCHES)
    lin = vsa_kernels.linearize(spec, xs, us, wterm)
    bw = riccati.riccati_fddp_backward(*derivs, fs, reg)
    torch.cuda.synchronize()
    for g, w in zip(_tensors(lin), _tensors(vsa_kernels.linearize_plain(spec, xs, us, wterm))):
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(g.nan_to_num(0.0), w.nan_to_num(0.0))
    _assert_same_bits(bw, riccati.riccati_fddp_plain(*derivs, fs, reg))
    if batch > 1:
        assert not bool(bw.ok.all()) and bool(bw.ok.any())
    k, K = torch.where(bw.ok, bw.k, 0.0), torch.where(bw.ok, bw.K, 0.0)
    ones = torch.ones(batch, dtype=dtype, device=cuda)
    infeas = (torch.arange(batch, device=cuda) % 2).to(dtype)
    args = (spec, xs, us, k, K, xs[0], ones, 0.5 * ones, wterm, None, None, fs, infeas)
    k6_args = args[:6] + args[7:]
    got = vsa_kernels.rollout2(*args)
    one = vsa_kernels.rollout1(*k6_args)
    torch.cuda.synchronize()
    for name in ("linearize", "riccati_fddp", "rollout2", "rollout1"):
        assert build.LAUNCHES[name] == before[name] + 1, name
    for g, w in zip(got, vsa_kernels.rollout2_plain(*args)):
        _assert_same_bits(g, w)
    _assert_same_bits(one, vsa_kernels.rollout1_plain(*k6_args))
    first, _ = vsa_kernels.rollout2(*k6_args[:7], 0.5 * k6_args[6], *k6_args[7:])
    _assert_same_bits(one, first)


def test_launchers_refuse_what_they_have_no_instance_for(cuda):
    """Asked for a chain length or an actuation they are not built for, the
    C launchers return -1 and ``build.check`` raises naming the shape; the
    wrappers raise before that and list the instances."""
    spec, xs, us, wterm, derivs, fs, reg = _ndof_inputs(3, torch.float64, cuda, 8)
    params = vsa_kernels.pack_params(spec)
    p = build.ptr
    outs = [torch.empty(1, device=cuda) for _ in range(14)]
    code = build.entry("aslr_linearize", torch.float64, 3)(
        params.ctypes.data_as(build.ctypes.c_void_p), 7, p(xs), p(us), p(wterm), None, T, 8,
        *[p(o) for o in outs], build.stream_of(xs))
    with pytest.raises(NotImplementedError, match="no instance for nl=7 sea"):
        build.check("linearize", code, "nl=7 sea")
    with pytest.raises(NotImplementedError, match="nl=5 sea; its instances"):
        build.require("linearize", "nl=5 sea")
    with pytest.raises(NotImplementedError, match="nl=3 vsa; its instances"):
        vsa_kernels.linearize(spec._replace(variant="vsa", nu=6), xs,
                              torch.zeros(T, 6, 8, dtype=torch.float64, device=cuda), wterm)


def _table_cases(dtype, device, B):
    """{case: (kernel wrapper, plain version, args, kwargs)} with the per-knot
    tables (rows all different): K1 with a target a knot on the VSA and SEA
    arms; K2 and K5 with [T, nu] box tables, knot 3 pinched; K3 and K6 with
    the box tables and the target table (VSA) and the target table (SEA
    gaps)."""
    cases = {}
    for arm in ("vsa", "sea"):
        w = (two_dof_vsa_boxddp if arm == "vsa" else two_dof_sea)(T=T, dtype=dtype,
                                                                   device=device)
        spec = vsa_kernels.extract_vsa_spec(w.problem, w.bounds)
        pk, tgt = per_knot_target(spec, T, dtype)
        tgt = tgt.to(device)
        rng = np.random.default_rng(2)

        def t(a):
            return torch.tensor(a, dtype=dtype, device=device)

        nu = spec.nu
        xs = t(0.3 * rng.standard_normal((T + 1, 8, B)))
        us = t(3.0 * rng.standard_normal((T, nu, B)))
        wterm = torch.full((B,), spec.w_goal_term, dtype=dtype, device=device)
        cases[f"linearize_{arm}"] = (vsa_kernels.linearize, vsa_kernels.linearize_plain,
                                     (pk, xs, us, wterm, tgt), {})
        lin = vsa_kernels.linearize_plain(pk, xs, us, wterm, tgt)
        r = lin.run
        derivs = (r["Fx"], r["Fu"], r["Lx"], r["Lu"], r["Lxx"], r["Lxu"], r["Luu"],
                  lin.term["Lx"], lin.term["Lxx"])
        lb, ub = (b.to(device) for b in box_tables(T, nu, dtype, pinch=3))
        kprev = t(0.5 * rng.standard_normal((T, nu, B)))
        reg = t(np.where(np.arange(B) % 10 == 0, -0.05, 1e-9))
        fs = torch.cat([torch.full_like(xs[:1], 0.01), lin.xnext - xs[1:]], dim=0)
        kw = dict(per_knot_box=True)
        if arm == "vsa":
            cases["riccati_box"] = (riccati.riccati_box_backward, riccati.riccati_box_plain,
                                    derivs + (us, kprev, lb, ub, reg, 2), kw)
        cases[f"riccati_boxfddp_{arm}"] = (
            riccati.riccati_boxfddp_backward, riccati.riccati_boxfddp_plain,
            derivs + (fs, us, None, lb, ub, reg, 6), kw)
        bw = riccati.riccati_boxfddp_plain(*derivs, fs, us, None, lb, ub, reg, 6, True)
        k = torch.where(bw.ok, bw.k, 0.0)
        K = torch.where(bw.ok, bw.K, 0.0)
        alphas = (t(np.ones(B)), t(0.5 ** (1 + np.arange(B) % 4)))
        if arm == "vsa":
            boxed = pk._replace(lb=lb.double().cpu().numpy(), ub=ub.double().cpu().numpy())
            args = (boxed, xs, us, k, K, xs[0].contiguous(), *alphas, wterm, lb, ub, None,
                    None, tgt)
        else:
            args = (pk, xs, us, k, K, xs[0].contiguous(), *alphas, wterm, None, None, fs,
                    t(np.arange(B) % 3 == 0), tgt)
        cases[f"rollout2_{arm}"] = (vsa_kernels.rollout2, vsa_kernels.rollout2_plain, args, {})
        cases[f"rollout1_{arm}"] = (vsa_kernels.rollout1, vsa_kernels.rollout1_plain,
                                    args[:6] + args[7:], {})
    return cases


TABLE_CASES = ["linearize_vsa", "linearize_sea", "riccati_box", "riccati_boxfddp_vsa",
               "riccati_boxfddp_sea", "rollout2_vsa", "rollout2_sea", "rollout1_vsa",
               "rollout1_sea"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("batch", [1, 15, 200])
@pytest.mark.parametrize("case", TABLE_CASES)
def test_table_variants_match_plain_version_to_the_bit(cuda, case, batch, dtype):
    """The per-knot table variants of K1, K2, K5, K3 and K6 equal their plain
    versions to the bit, flags and NaNs included."""
    fn, plain, args, kw = _table_cases(dtype, cuda, batch)[case]
    name = case.rsplit("_", 1)[0] if case != "riccati_box" else case
    before = build.LAUNCHES[name]
    got = fn(*args, **kw)
    assert build.LAUNCHES[name] == before + 1
    _assert_all_bits(got, plain(*args, **kw))


def _leaves(out):
    """Every tensor of a kernel's output: tuples and dicts opened, None
    skipped."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _leaves(v)
    elif isinstance(out, tuple):
        for v in out:
            yield from _leaves(v)


def _assert_all_bits(got, want):
    pairs = list(zip(_leaves(got), _leaves(want)))
    assert pairs and len(pairs) == len(list(_leaves(want)))
    for g, w in pairs:
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(g.nan_to_num(0.0), w.nan_to_num(0.0))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_tables_of_equal_rows_give_the_shared_bits(cuda, dtype):
    """A target table built from the shared target and box tables whose
    rows are the shared box give the shared route's bits, kernel against
    kernel: K1, K2, K5, K3 and K6 on the VSA arm."""
    inp = _inputs(dtype, cuda)
    spec = inp["spec"]
    tgt = torch.tensor(spec.target_table(T, dtype), device=cuda)
    lbt, ubt = (torch.tensor(np.tile(b, (T, 1)), dtype=dtype, device=cuda)
                for b in (spec.lb, spec.ub))
    tabled = spec._replace(lb=np.tile(spec.lb, (T, 1)), ub=np.tile(spec.ub, (T, 1)))
    lin = vsa_kernels.linearize(spec, inp["xs"], inp["us"], inp["wterm"])
    pairs = [(lin, vsa_kernels.linearize(spec, inp["xs"], inp["us"], inp["wterm"], tgt))]
    bw_args = _bw_args(inp, lin)
    bw = riccati.riccati_box_backward(*bw_args)
    tab_args = bw_args[:11] + (lbt, ubt) + bw_args[13:]
    pairs.append((bw, riccati.riccati_box_backward(*tab_args, per_knot_box=True)))
    fs = _gaps(inp, lin)
    pairs.append((riccati.riccati_boxfddp_backward(*bw_args[:9], fs, *bw_args[9:]),
                  riccati.riccati_boxfddp_backward(*tab_args[:9], fs, *tab_args[9:],
                                                   per_knot_box=True)))
    roll = _roll_args(inp, bw)
    roll_t = (tabled,) + roll[1:9] + (lbt, ubt)
    pairs.append((vsa_kernels.rollout2(*roll), vsa_kernels.rollout2(*roll_t, tgt=tgt)))
    pairs.append((vsa_kernels.rollout1(*roll[:6], *roll[7:]),
                  vsa_kernels.rollout1(*roll_t[:6], *roll_t[7:], tgt=tgt)))
    for shared, table in pairs:
        _assert_all_bits(table, shared)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("batch", [1, 15, 200])
@pytest.mark.parametrize("nl", [3, 7])
def test_ndof_table_instances_match_plain_version_to_the_bit(cuda, nl, batch, dtype):
    """K1, K3 and K6 at the 3- and 7-DoF SEA arms with a target a knot (the
    rollouts' table instances, K1's uniform branch) equal their plain
    versions to the bit."""
    spec, xs, us, wterm, derivs, fs, reg = _ndof_inputs(nl, dtype, cuda, batch)
    pk, tgt = per_knot_target(spec, T, dtype)
    tgt = tgt.to(cuda)
    _assert_all_bits(vsa_kernels.linearize(pk, xs, us, wterm, tgt),
                     vsa_kernels.linearize_plain(pk, xs, us, wterm, tgt))
    bw = riccati.riccati_fddp_plain(*derivs, fs, reg)
    k, K = torch.where(bw.ok, bw.k, 0.0), torch.where(bw.ok, bw.K, 0.0)
    ones = torch.ones(batch, dtype=dtype, device=cuda)
    infeas = (torch.arange(batch, device=cuda) % 3 == 0).to(dtype)
    args = (pk, xs, us, k, K, xs[0].contiguous(), ones, 0.5 * ones, wterm, None, None, fs,
            infeas, tgt)
    _assert_all_bits(vsa_kernels.rollout2(*args), vsa_kernels.rollout2_plain(*args))
    k6 = args[:6] + args[7:]
    _assert_all_bits(vsa_kernels.rollout1(*k6), vsa_kernels.rollout1_plain(*k6))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("batch", [15, 200])
def test_wide_layouts_keep_a_scenario_in_its_group(cuda, batch, dtype):
    """K6 at nl 7 (8 lanes a trajectory, four a warp) and K4 at (28, 7) (a
    warp a scenario, four a block) with scenario 5's inputs NaN: it fails
    alone, and every output equals the plain version to the bit."""
    spec, xs, us, wterm, derivs, fs, reg = _ndof_inputs(7, dtype, cuda, batch, seed=3)
    derivs = list(derivs)
    for i in range(len(derivs)):
        derivs[i] = derivs[i].clone()
        derivs[i][..., 5] = float("nan")
    bw = riccati.riccati_fddp_backward(*derivs, fs, reg)
    _assert_same_bits(bw, riccati.riccati_fddp_plain(*derivs, fs, reg))
    assert not bool(bw.ok[5]) and bool(bw.ok[[4, 6, 7]].all())
    k, K = torch.where(bw.ok, bw.k, 0.0), torch.where(bw.ok, bw.K, 0.0)
    k, K = k.clone(), K.clone()
    k[..., 5] = float("nan")
    ones = torch.ones(batch, dtype=dtype, device=cuda)
    infeas = (torch.arange(batch, device=cuda) % 2).to(dtype)
    args = (spec, xs, us, k, K, xs[0].contiguous(), 0.5 * ones, wterm, None, None, fs, infeas)
    one = vsa_kernels.rollout1(*args)
    _assert_same_bits(one, vsa_kernels.rollout1_plain(*args))
    assert bool(one.cost[5].isnan())
    assert bool(torch.isfinite(one.cost[[4, 6, 7]]).all())


def test_wide_layouts_fill_the_card(cuda):
    """At the 7-DoF path's B=1024, in one wave each: K6 at nl 7 runs 128
    blocks (the general layout ran 32 and left most SMs idle), and K4 at
    (28, 7) keeps two blocks resident an SM in f32 (the general layout one,
    in two waves)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k6 = build.launch_of("rollout1", torch.float32, 1024)
    k4 = build.launch_of("riccati_fddp", torch.float32, 1024)
    assert k6["grid"] == 128 and k6["grid"] <= sms * k6["blocks_per_sm"]
    assert k4["blocks_per_sm"] >= 2 and k4["grid"] <= sms * k4["blocks_per_sm"]



def _k3_layout_at(batch):
    """The layout K3 at nl 7 takes at a batch (rollout.cuh::rollout2_wide):
    wide while its general layout's blocks of 16 scenarios are fewer than
    the card's SMs."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return "wide" if (batch + 15) // 16 < sms else "general"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("batch", [1, 15, 200, 1024, 4096])
def test_k3_and_k1_nl7_match_plain_version_to_the_bit(cuda, batch, dtype):
    """K1 at nl 7 (its wide layout: each rotation and column solve once a
    group) and K3 at nl 7 in the layout its batch picks (wide up to 1024,
    general at 4096), in the shared and the table instances (a target a
    knot), equal their plain versions to the bit on ragged batches, and
    K3's first trial equals K6."""
    spec, xs, us, wterm, derivs, fs, reg = _ndof_inputs(7, dtype, cuda, batch, seed=4)
    assert build.launch_of("rollout2", dtype, batch)["layout"] == _k3_layout_at(batch)
    pk, tgt = per_knot_target(spec, T, dtype)
    tgt = tgt.to(cuda)
    for s, table in ((spec, None), (pk, tgt)):
        _assert_all_bits(vsa_kernels.linearize(s, xs, us, wterm, table),
                         vsa_kernels.linearize_plain(s, xs, us, wterm, table))
    bw = riccati.riccati_fddp_plain(*derivs, fs, reg)
    k, K = torch.where(bw.ok, bw.k, 0.0), torch.where(bw.ok, bw.K, 0.0)
    ones = torch.ones(batch, dtype=dtype, device=cuda)
    infeas = (torch.arange(batch, device=cuda) % 3 == 0).to(dtype)
    for s, table in ((spec, None), (pk, tgt)):
        args = (s, xs, us, k, K, xs[0].contiguous(), ones, 0.5 * ones, wterm, None, None, fs,
                infeas, table)
        before = build.LAUNCHES["rollout2"]
        got = vsa_kernels.rollout2(*args)
        assert build.LAUNCHES["rollout2"] == before + 1
        _assert_all_bits(got, vsa_kernels.rollout2_plain(*args))
        _assert_all_bits(vsa_kernels.rollout1(*args[:6], *args[7:]), got[1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("batch", [15, 200, 4096])
def test_k3_and_k1_nl7_keep_a_scenario_in_its_group(cuda, batch, dtype):
    """K1 and K3 at nl 7 with scenario 5's states (K1) or gains (K3) NaN:
    it fails alone, its neighbours of a group's warp stay finite, and every
    output equals the plain version to the bit (K3 in its wide layout at
    B=15 and 200, its general one at 4096)."""
    spec, xs, us, wterm, derivs, fs, reg = _ndof_inputs(7, dtype, cuda, batch, seed=5)
    bad = xs.clone()
    bad[0, :, 5] = float("nan")
    lin = vsa_kernels.linearize(spec, bad, us, wterm)
    _assert_all_bits(lin, vsa_kernels.linearize_plain(spec, bad, us, wterm))
    assert not bool(lin.ok[5]) and bool(lin.ok[[4, 6, 7]].all())
    bw = riccati.riccati_fddp_plain(*derivs, fs, reg)
    k, K = torch.where(bw.ok, bw.k, 0.0).clone(), torch.where(bw.ok, bw.K, 0.0)
    k[..., 5] = float("nan")
    ones = torch.ones(batch, dtype=dtype, device=cuda)
    infeas = (torch.arange(batch, device=cuda) % 2).to(dtype)
    args = (spec, xs, us, k, K, xs[0].contiguous(), ones, 0.5 * ones, wterm, None, None, fs,
            infeas)
    got = vsa_kernels.rollout2(*args)
    _assert_all_bits(got, vsa_kernels.rollout2_plain(*args))
    for trial in got:
        assert bool(trial.cost[5].isnan())
        assert bool(torch.isfinite(trial.cost[[4, 6, 7]]).all())


def test_k3_nl7_layout_follows_the_batch(cuda):
    """K3 at nl 7: at the 7-DoF path's B=1024 its general layout would run
    64 blocks on 132 SMs, so it takes the wide one, 128 blocks of 128
    threads in one wave; at B=4096 the general one, 256 blocks of 16
    scenarios. K1 there runs blocks of 128 threads, its groups' tiles in
    shared memory."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wide = build.launch_of("rollout2", torch.float32, 1024)
    general = build.launch_of("rollout2", torch.float32, 4096)
    assert wide["layout"] == _k3_layout_at(1024) == "wide"
    assert wide["grid"] == 128 and wide["grid"] <= sms * wide["blocks_per_sm"]
    assert general["layout"] == "general" and general["grid"] == 256
    k1 = build.launch_of("linearize", torch.float32, 1024, T=100)
    assert k1["threads"] == 128 and k1["smem"] > 0 and k1["blocks_per_sm"] >= 1


def _homotopy_x0s(cuda, B, inf_lane):
    g = torch.Generator(device=cuda).manual_seed(6)
    x0s = 0.05 * torch.randn(B, 8, generator=g, device=cuda, dtype=torch.float64)
    x0s[inf_lane, 0] = float("inf")
    return x0s


def test_homotopy_with_rescue_kernels_match_plain_on_card(cuda):
    """The staged homotopy with the diverged-lane rescue (the production
    schedules, 5 + 7 stages) through K1, K2 and K3 against its plain
    backend in f64; the lane at x0 = inf stays diverged."""
    from aslr_to_tpu_torch.measure import homotopy_solver

    x0s = _homotopy_x0s(cuda, 64, 3)
    res = {}
    for backend in ("auto", "plain"):
        solve = homotopy_solver("homotopy", T, torch.float64, device=cuda, backend=backend,
                                maxiter=4, rescue_size=8)
        build.reset_launches()
        res[backend] = solve(x0s)
        assert (build.LAUNCHES["riccati_box"] > 0) == (backend == "auto"), backend
    k, p = res["auto"], res["plain"]
    assert bool(k.diverged[3]) and bool(p.diverged[3])
    assert torch.equal(k.iterations, p.iterations)
    assert torch.equal(k.converged, p.converged) and torch.equal(k.diverged, p.diverged)
    live = ~p.diverged
    torch.testing.assert_close(k.cost[live], p.cost[live], rtol=1e-8, atol=0)
    torch.testing.assert_close(k.us[live], p.us[live], rtol=0, atol=1e-8)


def test_rescue_keeps_the_solved_lanes_on_card(cuda):
    """Through the kernels, the lanes that are not taken from the rescue
    keep the main pass's result to the bit (f32, rescue_size below the
    batch)."""
    from aslr_to_tpu_torch.measure import homotopy_solver

    x0s = (20.0 * _homotopy_x0s(cuda, B, 7)).float()
    plain = homotopy_solver("homotopy", T, torch.float32, device=cuda, maxiter=4,
                            rescue_size=0)(x0s)
    solve = homotopy_solver("homotopy", T, torch.float32, device=cuda, maxiter=4,
                            rescue_size=16)
    res = solve(x0s)
    taken = plain.diverged & ~res.diverged
    assert int(taken.sum()) == int(solve.stats["rescued"])
    kept = ~taken
    for a, b in zip(list(plain[:-1]) + list(plain.log), list(res[:-1]) + list(res.log)):
        a, b = a[kept].double(), b[kept].double()
        assert torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0),
                                                                 b.nan_to_num(0.0))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("batch", [1, 15, 200, 4096])
def test_k4_matches_plain_on_the_double_pendulum(cuda, batch, dtype):
    """K4 at (8, 2) on the double pendulum's data (T=10: a zero Fu column,
    Luu[1, 1] zero, an indefinite terminal Lxx, lanes that fail to factor):
    to the bit against its plain version, ok and retryable included, and
    k[:, 1], K[:, 1] exactly zero where a lane factors."""
    from cuda_on_cpu.pendulum import pendulum_k4_inputs, zero_column_kept

    args = pendulum_k4_inputs(batch, dtype, device=cuda)
    before = build.LAUNCHES["riccati_fddp"]
    got = riccati.riccati_fddp_backward(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES["riccati_fddp"] == before + 1
    want = riccati.riccati_fddp_plain(*args)
    _assert_same_bits(got, want)
    assert zero_column_kept(got) and zero_column_kept(want)
    assert not bool(got.ok[0])
    if batch > 1:
        assert bool(got.ok.any())


def test_double_pendulum_k4_route_against_scan_on_card(cuda):
    """The double pendulum's generic route through K4 against the generic
    sweep, f64, T=10, B=16, maxiter 20 (where the CPU tests hold both to
    JAX): iterations and flags equal, cost within rtol 1e-8; K4 launched
    only on its route."""
    from aslr_to_tpu_torch.measure import pendulum_solver

    w, _ = pendulum_solver(10, torch.float64, device=cuda)
    noise = 0.05 * np.random.default_rng(3).standard_normal((16, 8))
    x0s = w.problem.x0 + torch.tensor(noise, device=cuda)
    res, launched = {}, {}
    for k4 in (True, False):
        _, solve = pendulum_solver(10, torch.float64, device=cuda, use_pallas_backward=k4,
                                   maxiter=20)
        build.reset_launches()
        res[k4] = solve(x0s)
        torch.cuda.synchronize()
        launched[k4] = build.LAUNCHES["riccati_fddp"]
    assert launched[True] > 0 and launched[False] == 0
    a, b = res[True], res[False]
    assert torch.equal(a.iterations, b.iterations)
    assert torch.equal(a.converged, b.converged) and torch.equal(a.diverged, b.diverged)
    np.testing.assert_allclose(a.cost.cpu().numpy(), b.cost.cpu().numpy(), rtol=1e-8)


def test_generic_line_search_forms_agree_on_card(cuda, monkeypatch):
    """The generic route's line search on the card, all step lengths in one
    batched rollout against one trial a round with early exit, on the
    double pendulum (f64, T=10, B=16, maxiter 20, K4's route): iterations,
    flags and the step-length log equal, cost within rtol 1e-8."""
    from aslr_to_tpu_torch.measure import pendulum_solver
    from aslr_to_tpu_torch.solvers import ddp

    w, solve = pendulum_solver(10, torch.float64, device=cuda, maxiter=20, keep_log=True)
    noise = 0.05 * np.random.default_rng(5).standard_normal((16, 8))
    x0s = w.problem.x0 + torch.tensor(noise, device=cuda)
    res = {}
    for batched in (True, False):
        monkeypatch.setattr(ddp, "_all_trials_at_once", lambda fast, b=batched: b)
        res[batched] = solve(x0s)
        torch.cuda.synchronize()
    a, b = res[True], res[False]
    assert torch.equal(a.iterations, b.iterations)
    assert torch.equal(a.converged, b.converged) and torch.equal(a.diverged, b.diverged)
    assert torch.equal(a.log.steps.nan_to_num(-1.0), b.log.steps.nan_to_num(-1.0))
    np.testing.assert_allclose(a.cost.cpu().numpy(), b.cost.cpu().numpy(), rtol=1e-8)


def _ndof_box_args(nl, dtype, device, B, warm):
    """The n-DoF inputs of ``_ndof_inputs`` with a box of the lanes that the
    controls (3·randn) cross, joint j in [-(1 + 0.1 j), 1.2 + 0.1 j], and
    K5's warm start kprev (0.5·randn, 2 QP iterations) or None (cold, 6)."""
    spec, xs, us, wterm, derivs, fs, reg = _ndof_inputs(nl, dtype, device, B)
    j = torch.arange(nl, dtype=dtype, device=device)[:, None]
    lb, ub = (b.expand(nl, B).contiguous() for b in (-(1.0 + 0.1 * j), 1.2 + 0.1 * j))
    g = torch.Generator(device=device).manual_seed(1)
    kprev = (0.5 * torch.randn(T, nl, B, generator=g, device=device, dtype=dtype)
             if warm else None)
    k5 = derivs + (fs, us, kprev, lb, ub, reg, 2 if warm else 6)
    return spec, xs, us, wterm, fs, lb, ub, k5


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("batch", [1, 15, 200])
@pytest.mark.parametrize("nl", [3, 7])
def test_ndof_boxfddp_kernel_matches_plain_version_to_the_bit(cuda, nl, batch, warm, dtype):
    """K5 at (12, 3) and, in its wide layout, (28, 7), on ragged batches in a
    box that binds: equal to its plain version to the bit, flags included."""
    *_, k5 = _ndof_box_args(nl, dtype, cuda, batch, warm)
    before = build.LAUNCHES["riccati_boxfddp"]
    got = riccati.riccati_boxfddp_backward(*k5)
    torch.cuda.synchronize()
    assert build.LAUNCHES["riccati_boxfddp"] == before + 1
    _assert_same_bits(got, riccati.riccati_boxfddp_plain(*k5))
    us, lb, ub = k5[10], k5[12][None], k5[13][None]
    assert bool(((-got.k == lb - us) | (-got.k == ub - us)).any())
    if batch > 1:
        assert not bool(got.ok.all()) and bool(got.ok.any())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("batch", [1, 15, 200])
@pytest.mark.parametrize("variant", ["sea", "sea_box_gaps"])
@pytest.mark.parametrize("nl", [3, 7])
def test_ndof_rollout_variants_match_plain_version_to_the_bit(cuda, nl, variant, batch, dtype):
    """K3 and K6 at nl 3 and 7 without box or gaps (DDP's) and with a box
    and gaps (BoxFDDP's) on ragged batches, on K5's gains: equal to their
    plain versions to the bit, K6 to K3's first trial; the box clips."""
    spec, xs, us, wterm, fs, lb, ub, k5 = _ndof_box_args(nl, dtype, cuda, batch, True)
    bw = riccati.riccati_boxfddp_plain(*k5)
    k, K = torch.where(bw.ok, bw.k, 0.0), torch.where(bw.ok, bw.K, 0.0)
    ones = torch.ones(batch, dtype=dtype, device=cuda)
    infeas = (torch.arange(batch, device=cuda) % 2).to(dtype)
    tail = (lb, ub, fs, infeas) if variant == "sea_box_gaps" else (None, None, None, None)
    args = (spec, xs, us, k, K, xs[0].contiguous(), ones, 0.5 * ones, wterm) + tail
    k6_args = args[:6] + args[7:]
    before = dict(build.LAUNCHES)
    got = vsa_kernels.rollout2(*args)
    one = vsa_kernels.rollout1(*k6_args)
    torch.cuda.synchronize()
    for name in ("rollout2", "rollout1"):
        assert build.LAUNCHES[name] == before[name] + 1, name
    for g, w in zip(got, vsa_kernels.rollout2_plain(*args)):
        _assert_same_bits(g, w)
    _assert_same_bits(one, vsa_kernels.rollout1_plain(*k6_args))
    first, _ = vsa_kernels.rollout2(*k6_args[:7], 0.5 * k6_args[6], *k6_args[7:])
    _assert_same_bits(one, first)
    if variant == "sea_box_gaps":
        assert bool(((got[0].us == lb[None]) | (got[0].us == ub[None])).any())


def test_ndof_box_launches_on_card(cuda):
    """K5 at (28, 7) in its wide layout: a warp a scenario, 256 blocks at
    B=1024, two blocks an SM in f32 and one in f64; K6 at nl 7 in DDP's and
    BoxFDDP's variants 128 blocks, K3 wide at B=1024 and general at 4096."""
    k5 = build.launch_of("riccati_boxfddp", torch.float32, 1024)
    assert (k5["grid"], k5["threads"], k5["blocks_per_sm"]) == (256, 128, 2)
    assert build.launch_of("riccati_boxfddp", torch.float64, 1024)["blocks_per_sm"] == 1
    for variant in ("sea", "sea box gaps"):
        assert build.launch_of("rollout1", torch.float32, 1024, variant=variant)["grid"] == 128
        assert build.launch_of("rollout2", torch.float32, 1024, variant=variant)["layout"] == \
            _k3_layout_at(1024)
        assert build.launch_of("rollout2", torch.float32, 4096,
                               variant=variant)["layout"] == "general"


def test_ndof_box_refusals_on_card(cuda):
    """K2 above ndx 8, a box without gaps at nl 7 (BoxDDP's, which the JAX
    package's n-DoF lane route cannot take) and n-DoF box tables raise
    NotImplementedError naming the instances; the C launcher of the box
    kernel returns -1 for box tables at (28, 7)."""
    spec, xs, us, wterm, fs, lb, ub, k5 = _ndof_box_args(7, torch.float64, cuda, 8, True)
    before = dict(build.LAUNCHES)
    with pytest.raises(NotImplementedError, match="ndx=28 nu=7; its instances: ndx=8 nu=4"):
        riccati.riccati_box_backward(*(k5[:9] + k5[10:]))
    ones = torch.ones(8, dtype=torch.float64, device=cuda)
    args = (spec, xs, us, us, us[..., None, :].expand(T, 7, 28, 8).contiguous(),
            xs[0].contiguous(), ones, ones, wterm, lb, ub)
    with pytest.raises(NotImplementedError, match="no kernel instance for nl=7 sea box;"):
        vsa_kernels.rollout2(*args)
    tables = tuple(b[:, 0][None].expand(T, 7).contiguous() for b in (lb, ub))
    with pytest.raises(NotImplementedError, match="ndx=28 nu=7 box tables; its instances"):
        riccati.riccati_boxfddp_backward(*k5[:12], *tables, *k5[14:], per_knot_box=True)
    assert build.LAUNCHES == before
    p = build.ptr
    out = [torch.empty(1, device=cuda) for _ in range(8)] + \
        [torch.empty(1, dtype=torch.bool, device=cuda) for _ in range(2)]
    code = build.entry("aslr_riccati_box", torch.float64)(
        28, 7, 1, *[p(a) for a in k5[:10]], p(k5[10]), p(k5[11]), None, None, p(tables[0]),
        p(tables[1]), p(k5[14]), T, 8, 2, *[p(o) for o in out], build.stream_of(xs))
    assert code == -1


def _k5_wide_args(box, dtype, device, B, warm):
    """K5's inputs at (28, 7) of ``_ndof_box_args`` in one of three boxes:
    ``binds`` (theirs), ``all_clamped`` (lb = ub = 0.3: every control on its
    bound, the free set empty) or ``none_clamped`` (±1e6: none on one)."""
    *_, k5 = _ndof_box_args(7, dtype, device, B, warm)
    if box != "binds":
        top = 0.3 if box == "all_clamped" else 1e6
        low = top if box == "all_clamped" else -top
        k5 = k5[:12] + tuple(torch.full((7, B), v, dtype=dtype, device=device)
                             for v in (low, top)) + k5[14:]
    return k5


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("batch", [1, 15, 200])
@pytest.mark.parametrize("box", ["binds", "all_clamped", "none_clamped"])
def test_k5_wide_corners_match_plain_version_to_the_bit(cuda, box, batch, warm, dtype):
    """K5 at (28, 7), its BoxQP spread over the warp (boxqp_rows), in a box
    that binds, one that clamps every control (lb = ub) and one that clamps
    none, warm (2 QP iterations) and cold (6), every tenth lane at a
    negative reg, on ragged batches: equal to its plain version to the bit,
    flags included."""
    k5 = _k5_wide_args(box, dtype, cuda, batch, warm)
    before = build.LAUNCHES["riccati_boxfddp"]
    got = riccati.riccati_boxfddp_backward(*k5)
    torch.cuda.synchronize()
    assert build.LAUNCHES["riccati_boxfddp"] == before + 1
    _assert_same_bits(got, riccati.riccati_boxfddp_plain(*k5))
    us, lb, ub = k5[10], k5[12][None], k5[13][None]
    on = (-got.k == lb - us) | (-got.k == ub - us)
    if box == "all_clamped":
        assert bool(on.all()) and bool((got.K == 0).all())
    elif box == "none_clamped":
        assert not bool((on & got.ok[None, None]).any())
    else:
        assert bool(on.any()) and not bool(on.all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_k5_wide_nonfinite_quu_fails_alone_on_card(cuda, dtype):
    """Scenario 6's Luu infinite at knot 2 (its Quu not finite there): it
    fails and is not retryable, every other scenario's outputs keep the bits
    they have without it, and all equal the plain version to the bit."""
    k5 = list(_k5_wide_args("binds", dtype, cuda, 15, True))
    base = riccati.riccati_boxfddp_backward(*k5)
    k5[6] = k5[6].clone()
    k5[6][2, 3, 3, 6] = float("inf")
    got = riccati.riccati_boxfddp_backward(*k5)
    torch.cuda.synchronize()
    _assert_same_bits(got, riccati.riccati_boxfddp_plain(*k5))
    assert bool(base.ok[6]) and not bool(got.ok[6]) and not bool(got.retryable[6])
    rest = torch.arange(15, device=cuda) != 6
    _assert_same_bits(type(got)(*(v[..., rest] for v in got)),
                      type(base)(*(v[..., rest] for v in base)))


@pytest.mark.parametrize("dtype,smem,blocks", [(torch.float32, 98176, 2),
                                               (torch.float64, 194944, 1)], ids=["f32", "f64"])
def test_k5_wide_launch_on_card(cuda, dtype, smem, blocks):
    """K5 at (28, 7) at B=1024 and 4096: a warp a scenario in blocks of 128
    threads (256 and 1024 blocks), 98,176 bytes of dynamic shared memory in
    f32 (two blocks an SM: B=1024 in one wave on 132 SMs) and 194,944 in
    f64 (one)."""
    for B in (1024, 4096):
        info = build.launch_of("riccati_boxfddp", dtype, B)
        assert info == dict(grid=B // 4, threads=128, smem=smem, blocks_per_sm=blocks)


@pytest.mark.parametrize("route", ["lanes", "fast"])
@pytest.mark.parametrize("family", ["sevendof_box", "sevendof_ddp"])
def test_ndof_box_and_ddp_solves_match_plain_on_card(cuda, family, route):
    """The 7-DoF BoxFDDP (the sevendof_box paths' box) and DDP solves on the
    lane and fast routes through their kernels equal the same routes through
    the plain versions to the bit, f64, T=12, B=8, maxiter 4."""
    from aslr_to_tpu_torch.measure import SEEDS, sevendof_solver, x0_batch

    name = family if route == "lanes" else f"fast_{family}"
    x0s = x0_batch(8, torch.float64, SEEDS[name], nx=28)
    k, p = (sevendof_solver(name, T, torch.float64, backend=backend, maxiter=4)(x0s)
            for backend in ("auto", "plain"))
    for field in ("xs", "us", "cost", "iterations", "converged", "diverged"):
        a, b = getattr(k, field), getattr(p, field)
        assert torch.equal(a.isnan(), b.isnan()) if a.is_floating_point() else True, field
        assert torch.equal(a.nan_to_num(0.0) if a.is_floating_point() else a,
                           b.nan_to_num(0.0) if b.is_floating_point() else b), field
