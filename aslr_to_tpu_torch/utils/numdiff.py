"""Finite-difference derivative oracle for tests.

PyTorch counterpart of ``aslr_to_tpu/utils/numdiff.py`` (the reference's
``crocoddyl.DifferentialActionModelNumDiff`` + ``assertNumDiff`` harness,
``unittest/test_utils_ex.py:4-20``): central differences around a nominal
point, with the reference's tolerance convention (``NUMDIFF_MODIFIER =
3e4`` times the disturbance).
"""
from __future__ import annotations

import torch

NUMDIFF_MODIFIER = 3e4  # reference unittest/test_utils_ex.py:4


def numdiff(fn, x, eps: float = 1e-6):
    """Central-difference Jacobian of ``fn`` at the vector ``x [n]``: a
    tensor ``fn(x).shape + (n,)`` (the last axis the inputs), in float64 on
    ``x``'s device."""
    x = torch.as_tensor(x, dtype=torch.float64)
    f0 = torch.as_tensor(fn(x))
    J = torch.zeros(f0.shape + (x.numel(),), dtype=torch.float64, device=x.device)
    for i in range(x.numel()):
        dx = torch.zeros_like(x)
        dx.view(-1)[i] = eps
        J[..., i] = (torch.as_tensor(fn(x + dx)) - torch.as_tensor(fn(x - dx))) / (2.0 * eps)
    return J


def assert_numdiff(analytic, numerical, tol: float = NUMDIFF_MODIFIER * 1e-6, msg: str = ""):
    """Assert ``max |analytic - numerical| < tol`` (the reference's NUMDIFF
    tolerance)."""
    err = float((torch.as_tensor(analytic, dtype=torch.float64)
                 - torch.as_tensor(numerical, dtype=torch.float64)).abs().max())
    assert err < tol, f"numdiff mismatch {msg}: max err {err} > tol {tol}"
