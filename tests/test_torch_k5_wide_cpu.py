"""K5 at (ndx, nu) = (28, 7), the 7-DoF arm's BoxFDDP backward in its wide
layout (a warp a scenario), run on the CPU: its BoxQP spread over the warp
(``csrc/boxqp.cuh::boxqp_rows``: a lane a row of the QP, the masked factor a
column at a time, the Armijo trials on groups of seven lanes).

The CUDA source compiles with g++ against the stand-ins of
``tests/cuda_on_cpu`` (one thread per CUDA thread, __syncthreads at a
barrier over the block and the warp primitives at one over the warp, so a
warp may branch alone; shared memory refilled with NaN bytes before each
block). The wrapper, pointed at that library, is held to its plain version
to the bit in f64 and f32, NaNs and flags included, at B=1, 5 and 33 (four
scenarios a block: 5 and 33 end in a partial block), warm (kprev, 2 QP
iterations) and cold (no kprev, 6), every tenth lane at a negative reg, in
three boxes:

- ``binds``: controls of 3·randn in a box of about ±1-2, so that some
  controls clamp and the free set changes from one QP iteration to the next
  (the factor rebuilt), and some QP iterations accept none of the five
  trials (both counted on the plain version's iterates);
- ``all_clamped``: lb = ub, every control on its bound, the free set empty;
- ``none_clamped``: a box of ±1e6 that no control reaches.

Then one scenario whose Quu is not finite at a knot fails alone in its block,
not retryable, beside the retryable failures of the negative reg.
"""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest
import torch

from aslr_to_tpu_torch import seven_dof_sea
from aslr_to_tpu_torch.kernels import build, riccati, vsa_kernels
from cuda_on_cpu.gxx import gxx_library, ieee_sqrt

DTYPES = dict(argnames="dtype", argvalues=[torch.float64, torch.float32], ids=["f64", "f32"])
T = 4
NL = 7


@pytest.fixture(scope="module")
def k5_handle(tmp_path_factory):
    return gxx_library(tmp_path_factory.mktemp("k5_wide_kernel"), ["riccati_box.cu"],
                       "sweep_smem", ["aslr_riccati_box", "aslr_riccati_fddp",
                                      "aslr_riccati_boxfddp_n7_launch"])


@pytest.fixture
def k5_lib(k5_handle, monkeypatch):
    """The wrapper launches the CPU build on CPU tensors, and the plain
    version takes a correctly rounded square root, for the test."""
    monkeypatch.setattr(build, "_lib", k5_handle)
    monkeypatch.setattr(riccati, "_route", lambda t: "kernel")
    monkeypatch.setattr(build, "stream_of", lambda t: None)
    monkeypatch.setattr(torch, "sqrt", ieee_sqrt)
    return k5_handle


def _box(kind, B, dtype):
    """The lanes' box [7, B]: ``binds`` joint j in [-(1 + 0.1 j), 1.2 + 0.1 j],
    ``all_clamped`` lb = ub = 0.3, ``none_clamped`` ±1e6."""
    j = np.arange(NL)
    lb, ub = dict(binds=(-(1.0 + 0.1 * j), 1.2 + 0.1 * j),
                  all_clamped=(np.full(NL, 0.3), np.full(NL, 0.3)),
                  none_clamped=(np.full(NL, -1e6), np.full(NL, 1e6)))[kind]
    return [torch.tensor(np.repeat(b[:, None], B, axis=1), dtype=dtype) for b in (lb, ub)]


def _args(box, B, dtype, warm, seed=0):
    """K5's arguments at (28, 7): the derivatives of a random trajectory of
    the 7-DoF SEA arm with gaps, controls 3·randn, kprev 0.5·randn (warm) or
    None (cold), every tenth lane at reg -0.05."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=dtype)

    w = seven_dof_sea(T=T, dtype=dtype, device="cpu")
    spec = vsa_kernels.extract_vsa_spec(w.problem, None)
    xs = t(0.3 * rng.standard_normal((T + 1, 4 * NL, B)))
    us = t(3.0 * rng.standard_normal((T, NL, B)))
    lin = vsa_kernels.linearize_plain(spec, xs, us, torch.full((B,), spec.w_goal_term,
                                                                dtype=dtype))
    r = lin.run
    fs = torch.cat([torch.full_like(xs[:1], 0.01), lin.xnext - xs[1:]], dim=0)
    reg = t(np.where(np.arange(B) % 10 == 0, -0.05, 1e-9))
    kprev = t(0.5 * rng.standard_normal((T, NL, B))) if warm else None
    lb, ub = _box(box, B, dtype)
    return [r["Fx"], r["Fu"], r["Lx"], r["Lu"], r["Lxx"], r["Lxu"], r["Luu"], lin.term["Lx"],
            lin.term["Lxx"], fs, us, kprev, lb, ub, reg, 2 if warm else 6]


def _assert_same_bits(got, want):
    for name, g, w in zip(want._fields, got, want):
        assert torch.equal(g.isnan(), w.isnan()), name
        assert torch.equal(g.nan_to_num(0.0), w.nan_to_num(0.0)), name


def _qp_events(monkeypatch):
    """Count, on the plain version's BoxQPs replayed an iteration at a time,
    the lanes and iterations whose free set differs from the iteration
    before (the factor rebuilt) and those, with finite values, where none of
    the five trials passes the Armijo test."""
    plain = riccati.boxqp_plain
    seen = dict(rebuilt=0, none_taken=0)

    def replay(H, q, low, up, x, iters):
        xs = [plain(H, q, low, up, x, n) for n in range(iters + 1)]
        for n in range(iters):
            xn, free = xs[n]
            g, _ = riccati._free_mask(H, q, xn, low, up)
            dx = -riccati._chol_solve(riccati._masked_factor(H, free), g * free)
            alphas = torch.tensor(riccati.QP_ALPHAS, dtype=xn.dtype)[:, None, None]
            fa = riccati._quad(H, q, riccati._clip(xn + alphas * dx, low, up))
            f0, gdx = riccati._quad(H, q, xn), riccati._dot(g, dx)
            taken = torch.stack([fa[s] - f0 <= (0.1 * a) * gdx
                                 for s, a in enumerate(riccati.QP_ALPHAS)]).any(0)
            finite = torch.isfinite(fa).all(0) & torch.isfinite(f0) & torch.isfinite(gdx)
            seen["none_taken"] += int((finite & ~taken).sum())
            seen["rebuilt"] += int((xs[n + 1][1] != free).any(0).sum())
        return xs[-1]

    monkeypatch.setattr(riccati, "boxqp_plain", replay)
    return seen


@pytest.mark.parametrize(**DTYPES)
@pytest.mark.parametrize("batch", [1, 5, 33])
@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("box", ["binds", "all_clamped", "none_clamped"])
def test_k5_wide_on_cpu_matches_plain_version(k5_lib, monkeypatch, box, warm, batch, dtype):
    """K5 at (28, 7) equal to its plain version to the bit in each box, warm
    and cold; in the binding box the QPs clamp, rebuild their factor and
    reject every trial somewhere; lb = ub clamps every control, the wide box
    none."""
    args = _args(box, batch, dtype, warm)
    before = build.LAUNCHES["riccati_boxfddp"]
    got = riccati.riccati_boxfddp_backward(*args)
    assert build.LAUNCHES["riccati_boxfddp"] == before + 1
    seen = _qp_events(monkeypatch) if box == "binds" and batch == 33 else None
    _assert_same_bits(got, riccati.riccati_boxfddp_plain(*args))
    us, lb, ub = args[10], args[12], args[13]
    du = -got.k
    on = (du == lb - us) | (du == ub - us)
    ok = got.ok[None, None]
    if box == "all_clamped":
        assert bool(on.all()) and bool((got.K == 0).all())
    elif box == "none_clamped":
        assert not bool((on & ok).any())
    else:
        assert bool((on & (ok | (batch == 1))).any()) and not bool(on.all())
    if seen is not None:
        assert seen["rebuilt"] > 0 and seen["none_taken"] > 0, seen
    if batch > 1 and box != "all_clamped":  # lane 0 at a negative reg
        assert not bool(got.ok.all()) and bool(got.ok.any())
        assert bool(got.retryable.any())


@pytest.mark.parametrize(**DTYPES)
def test_k5_wide_on_cpu_nonfinite_quu_fails_alone(k5_lib, dtype):
    """Scenario 6's Luu infinite at knot 2: its Quu is not finite, so it
    fails and is not retryable; the other scenarios of its block (4, 5, 7)
    keep ok, lanes 0 and 10 (negative reg) fail retryable, and all equal the
    plain version to the bit."""
    args = _args("binds", 12, dtype, True, seed=1)
    args[6] = args[6].clone()
    args[6][2, 3, 3, 6] = float("inf")
    got = riccati.riccati_boxfddp_backward(*args)
    _assert_same_bits(got, riccati.riccati_boxfddp_plain(*args))
    assert not bool(got.ok[6]) and not bool(got.retryable[6])
    assert bool(got.ok[[4, 5, 7]].all())
    assert not bool(got.ok[[0, 10]].any()) and bool(got.retryable[[0, 10]].all())
