"""P: dependent multiply-add chains per thread on the card (``csrc/probe.cu``).

The Hopper counterpart of ``scripts/probe_sublane.py``. Per element of a
float32 batch ``x``, ``ilp`` interleaved chains ``x_k <- x_k * 0.9999 +
x0`` run ``CHAIN // ilp`` steps each, ``LOOP`` times over, from ``x_k = x0
1e-6 (k + 1)``, and the chains are summed. The axes are what the H100
offers in place of the TPU's sublane packing: independent chains per
thread (``ILPS``), threads in flight (``BATCHES``: 65536 is about a quarter
of the card's 132 SMs x 2048 resident threads, 1048576 fills it), and the
arithmetic (``MODES``: a separate multiply and add, two roundings, as
``-fmad=false`` gives the port's other kernels; or ``fmaf``, one rounding).

    python -m aslr_to_tpu_torch.probe

prints, for each configuration, the kernel's time (CUDA events), its
GFLOP/s (2 flops a step), the bound (the flops over the card's float32
peak) and the error against the plain version, then one JSON line. Needs a
CUDA device.
"""
from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from .kernels import build as _build
from .kernels.vsa_kernels import _route

CHAIN, LOOP = 250, 96
ILPS = (1, 2, 4, 8)
BATCHES = (65536, 1048576)
MODES = ("mul_add", "fma")
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
_C = float(np.float32(0.9999))


def flops(B, ilp, chain=CHAIN, loop=LOOP):
    """The multiply-adds of one call, 2 flops each."""
    return 2 * B * (chain // ilp) * ilp * loop


def probe_plain(x, ilp, fma=False, chain=CHAIN, loop=LOOP):
    """The recurrence in PyTorch on ``x [B]`` float32: a float32 multiply
    then add (``fma=False``), or the product and sum in float64 rounded
    once to float32 (``fma=True``; a float32 product is exact in float64,
    so this is ``fmaf`` but for a rare double rounding)."""
    xs = torch.stack([x * (1e-6 * (k + 1)) for k in range(ilp)])
    x64 = x.double()
    for _ in range(loop):
        for _ in range(chain // ilp):
            if fma:
                xs = (xs.double() * _C + x64).float()
            else:
                xs = xs * _C + x
    acc = xs[0]
    for k in range(1, ilp):
        acc = acc + xs[k]
    return acc


def probe(x, ilp, fma=False, chain=CHAIN, loop=LOOP):
    """P on a float32 ``x [B]``: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if _route(x) == "plain":
        return probe_plain(x, ilp, fma, chain, loop)
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError("probe: expected a contiguous 1-d tensor")
    out = torch.empty_like(x)
    code = _build.entry("aslr_probe", x.dtype)(
        _build.ptr(x), _build.ptr(out), x.shape[0], ilp, int(fma), chain // ilp, loop,
        _build.stream_of(x))
    _build.check("probe", code)
    return out


def inputs(B, seed=0):
    """x = uniform(0.5e-3, 2e-3) float32 on the card, from a seeded generator."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return 0.5e-3 + 1.5e-3 * torch.rand(B, generator=g, device="cuda", dtype=torch.float32)


def timed(fn):
    """(result, ms) of one call, by CUDA events."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(fn, reps):
    """Mean ms of ``reps`` calls after a warm-up call, by CUDA events."""
    fn()
    return timed(lambda: [fn() for _ in range(reps)])[1] / reps


def _rel(a, b):
    return float(((a - b).abs() / b.abs()).max())


def run(reps=5, log=print):
    """Every configuration against its plain version (timed once, with CUDA
    events); returns the rows. The mul+add mode must equal its plain
    version to the bit and the fma mode be within 1e-6 relative of its own
    (the plain fma rounds twice in rare steps); raises otherwise."""
    rows = []
    for B in BATCHES:
        x = inputs(B)
        for ilp in ILPS:
            plain = {}
            for mode in MODES:
                fma = mode == "fma"
                got = probe(x, ilp, fma, CHAIN, LOOP)
                want, plain_ms = timed(lambda: probe_plain(x, ilp, fma, CHAIN, LOOP))
                plain[mode] = want
                abs_err = float((got - want).abs().max())
                err = _rel(got, want)
                if (err != 0.0) if not fma else not err <= 1e-6:
                    raise AssertionError(f"probe B={B} ilp={ilp} {mode}: relative error "
                                         f"{err:.3e} against the plain version")
                mul_add_err = _rel(got, plain["mul_add"]) if fma else 0.0
                ms = cuda_ms(lambda: probe(x, ilp, fma, CHAIN, LOOP), reps)
                n = flops(B, ilp, CHAIN, LOOP)
                bound_ms = n / F32_OPS_PER_S * 1e3
                row = dict(B=B, ilp=ilp, mode=mode, ms=ms, gflops=n / ms / 1e6,
                           bound_ms=bound_ms, bound_share=bound_ms / ms, plain_ms=plain_ms,
                           max_abs_err=abs_err, max_rel_err=err,
                           rel_diff_to_mul_add=mul_add_err, flops=n)
                rows.append(row)
                log(f"  probe B={B:8d} ilp={ilp} {mode:7s}: {ms:9.4f} ms, "
                    f"{row['gflops']:10.1f} GFLOP/s, bound {bound_ms:.4f} ms "
                    f"({100 * row['bound_share']:.1f}%), plain {plain_ms:.1f} ms, "
                    f"rel err {err:.2e}" + (f", vs mul+add {mul_add_err:.2e}" if fma else ""))
    return rows


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probe measures the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; CHAIN={CHAIN}, LOOP={LOOP}", flush=True)
    _build.lib()
    rows = run(log=lambda m: print(m, flush=True))
    print(json.dumps(dict(card=card, chain=CHAIN, loop=LOOP, rows=rows)))


if __name__ == "__main__":
    main()
