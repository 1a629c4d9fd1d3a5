"""P's plain version against the TPU kernel it ports,
``scripts/probe_sublane.py::make_kernel``, run in Pallas interpret mode.

The script is imported by path and left as it is: its constants CHAIN and
LOOP are shrunk with ``monkeypatch`` and its ``pl`` namespace is swapped
for one whose ``pallas_call`` passes ``interpret=True``. On the CPU, XLA
contracts the kernel's ``x * 0.9999 + x0`` into one fused multiply-add, so
the interpreted kernel equals the plain version's fma mode (the float64
product and sum rounded once to float32) to the bit; the mul+add mode
(two roundings, what the port's CUDA kernels compute under -fmad=false)
stays within 1e-5 relative at these chain lengths, and equals the same
recurrence restated in numpy float32 to the bit.
"""
import functools
import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aslr_to_tpu_torch import probe

SCRIPT = os.path.join(os.path.dirname(__file__), os.pardir, "scripts", "probe_sublane.py")
CHAIN, LOOP = 24, 3


@pytest.fixture()
def tpu_probe(monkeypatch):
    spec = importlib.util.spec_from_file_location("probe_sublane", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "CHAIN", CHAIN)
    monkeypatch.setattr(mod, "LOOP", LOOP)
    pl = mod.pl
    monkeypatch.setattr(mod, "pl", types.SimpleNamespace(
        BlockSpec=pl.BlockSpec, pallas_call=functools.partial(pl.pallas_call, interpret=True)))
    return mod


@pytest.mark.parametrize("pack,ilp", [(1, 1), (1, 2), (2, 4), (8, 8)])
def test_probe_plain_matches_the_tpu_kernel(tpu_probe, pack, ilp):
    x = np.random.default_rng(ilp).uniform(0.5e-3, 2e-3, (2, pack, 128)).astype(np.float32)
    fn = tpu_probe.make_kernel((pack, 128), 2 if pack > 1 else 1, ilp)
    want = np.asarray(fn(jnp.asarray(x))).ravel()
    xt = torch.tensor(x.ravel())
    fma = probe.probe_plain(xt, ilp, fma=True, chain=CHAIN, loop=LOOP)
    np.testing.assert_array_equal(fma.numpy(), want)
    mul_add = probe.probe_plain(xt, ilp, fma=False, chain=CHAIN, loop=LOOP)
    np.testing.assert_allclose(mul_add.numpy(), want, rtol=1e-5, atol=0)

    # the mul+add mode is the recurrence of probe_sublane.py:40-54 in float32
    x0, c = x.ravel(), np.float32(0.9999)
    xs = [x0 * np.float32(1e-6 * (k + 1)) for k in range(ilp)]
    for _ in range(LOOP):
        for _ in range(CHAIN // ilp):
            xs = [v * c + x0 for v in xs]
    acc = xs[0]
    for v in xs[1:]:
        acc = acc + v
    np.testing.assert_array_equal(mul_add.numpy(), acc)


def test_probe_wrapper_takes_the_plain_version_on_the_cpu():
    from aslr_to_tpu_torch.kernels import build

    x = torch.full((300,), 1e-3, dtype=torch.float32)
    build.reset_launches()
    out = probe.probe(x, 4, fma=False, chain=CHAIN, loop=LOOP)
    assert build.LAUNCHES["probe"] == 0
    assert torch.equal(out, probe.probe_plain(x, 4, chain=CHAIN, loop=LOOP))
    assert probe.flops(300, 4, CHAIN, LOOP) == 2 * 300 * CHAIN * LOOP
