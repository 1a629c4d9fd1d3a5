"""K4's inputs from the double pendulum for the kernel tests: the
linearization of the preset (T=10) along a random trajectory around the
hanging start, in lane layout. Its data is what the swing-up gives K4: Fu's
second column and Luu[1, 1] zero (the second control drives nothing and
is not weighted), a terminal Lxx indefinite at the hanging start; every
tenth lane at a negative reg, so that some lanes fail to factor."""
import dataclasses

import numpy as np
import torch

from aslr_to_tpu_torch import double_pendulum
from aslr_to_tpu_torch.kernels.vsa_kernels import to_lanes
from aslr_to_tpu_torch.solvers import ddp

T = 10
X0 = np.array([3.14, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])


def pendulum_k4_inputs(B, dtype, device="cpu", seed=0):
    """(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx, fs, reg) in lane layout,
    K4's arguments."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    w = double_pendulum(T=T, dtype=dtype, device=device)
    x0s = t(X0 + 0.05 * rng.standard_normal((B, 8)))
    xs = x0s[:, None] + t(0.2 * rng.standard_normal((B, T + 1, 8)))
    us = t(2.0 * rng.standard_normal((B, T, 2)))
    p = dataclasses.replace(w.problem, x0=x0s)
    _, run, term, xnext, _ = ddp._linearize_core(p, xs, us)
    fs = ddp._gaps(p, xs, xnext)
    derivs = [to_lanes(getattr(run, n)) for n in ("Fx", "Fu", "Lx", "Lu", "Lxx", "Lxu", "Luu")]
    reg = t(np.where(np.arange(B) % 10 == 0, -0.05, 1e-9))
    return tuple(derivs + [to_lanes(term.Lx), to_lanes(term.Lxx), to_lanes(fs), reg])


def zero_column_kept(out):
    """k[:, 1] and K[:, 1, :] exactly zero on every lane that factored."""
    ok = out.ok
    return bool((out.k[:, 1][:, ok] == 0).all()) and bool((out.K[:, 1][..., ok] == 0).all())
