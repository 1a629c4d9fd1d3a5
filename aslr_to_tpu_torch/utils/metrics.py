"""Solution metrics (reference ``python/aslr_to/__init__.py:63-68``).

PyTorch counterpart of ``aslr_to_tpu/utils/metrics.py``.
"""
from __future__ import annotations

import torch


def u_squared(us: torch.Tensor) -> torch.Tensor:
    """Per-channel sum of squared controls over the horizon: ``us [..., T,
    nu]`` -> ``[..., nu]`` (the reference's ``aslr_to.u_squared(log)`` on
    the solver's control trajectory instead of a callback log)."""
    return torch.square(us).sum(dim=-2)
