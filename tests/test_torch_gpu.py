"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA
device; the decision is taken inside a fixture, so every worker collects
the same tests. The file imports no JAX, so it also runs on a machine
without it. K1-K3 run on the VSA arm and again in their SEA and gap
variants; K4 on the SEA arm with gaps; the box kernel (K2, and K5 at nu 4
and 2) on ragged batches, warm and cold, and with one NaN scenario among
healthy ones in its warp; K6 in its box,
SEA-gap and unbounded variants, also against K3's first trial; K3 and K6
in every variant on ragged batches, to the bit; the fast
path of the per-scenario solver against its plain backend; P against its
plain version:

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

from aslr_to_tpu_torch import SolverSettings, make_batched_solver, two_dof_sea, two_dof_vsa_boxddp
from aslr_to_tpu_torch import probe
from aslr_to_tpu_torch.kernels import build, riccati, vsa_kernels

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
