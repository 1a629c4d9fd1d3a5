"""Shooting problem: T running knots sharing one action model, or one
model a knot, plus a terminal model.

PyTorch counterpart of ``aslr_to_tpu/solvers/problem.py``. Per-knot
problems (a time-varying tracking target, a control box a knot): build T
structurally identical models, stack them with :func:`stack_knots` and set
``per_knot=True``; every tensor leaf of ``running`` then carries a leading
``[T]`` axis and the solver evaluates knot t with :meth:`knot_model`.
"""
from __future__ import annotations

import dataclasses
import functools

import torch


def _rebuild(obj, values):
    """``obj``'s type with its fields (a dataclass, a NamedTuple, a tuple or
    a list) replaced by ``values``, without running ``__init__``."""
    if dataclasses.is_dataclass(obj):
        out = object.__new__(type(obj))
        for f, v in zip(dataclasses.fields(obj), values):
            object.__setattr__(out, f.name, v)
        return out
    if hasattr(obj, "_fields"):
        return type(obj)(*values)
    return type(obj)(values)


def _children(obj):
    """The fields of a dataclass instance, a NamedTuple, a tuple or a list;
    None for a leaf."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    if isinstance(obj, (tuple, list)):
        return list(obj)
    return None


def _first_tensor(obj):
    if isinstance(obj, torch.Tensor):
        return obj
    for c in _children(obj) or ():
        t = _first_tensor(c)
        if t is not None:
            return t
    return None


def _stack(leaves, like, path):
    first = leaves[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(leaves)
    kids = _children(first)
    if kids is not None:
        all_kids = [_children(m) for m in leaves]
        if any(type(m) is not type(first) or len(k) != len(kids)
               for m, k in zip(leaves, all_kids)):
            raise ValueError(f"stack_knots: the knots differ in structure at {path}")
        return _rebuild(first, [_stack([k[i] for k in all_kids], like, f"{path}[{i}]")
                                for i in range(len(kids))])
    if isinstance(first, float):
        if all(v == first for v in leaves):
            return first
        return torch.tensor(leaves, dtype=like.dtype, device=like.device)
    if all(v == first for v in leaves):
        return first
    raise ValueError(f"stack_knots: the static field {path} differs between knots")


def stack_knots(models):
    """Stack a sequence of structurally identical action models (frozen
    dataclasses and NamedTuples of tensors) into one per-knot model: every
    tensor leaf gains a leading ``[T]`` axis, and a float leaf that differs
    between knots becomes a ``[T]`` tensor (one that does not stays a
    float). Use with ``ShootingProblem(per_knot=True)``."""
    models = list(models)
    like = _first_tensor(models[0])
    return _stack(models, like, type(models[0]).__name__)


def _slice(obj, t):
    if isinstance(obj, torch.Tensor):
        return obj[t]
    kids = _children(obj)
    if kids is None:
        return obj
    return _rebuild(obj, [_slice(k, t) for k in kids])


@dataclasses.dataclass(frozen=True)
class ShootingProblem:
    x0: torch.Tensor
    running: object
    terminal: object
    T: int
    per_knot: bool = False

    @functools.cached_property
    def knot_models(self):
        """The action model of every knot (``running`` itself T times when
        the model is shared)."""
        if not self.per_knot:
            return (self.running,) * self.T
        return tuple(_slice(self.running, t) for t in range(self.T))

    def knot_model(self, t: int):
        """The action model at knot ``t`` (the per-knot leaves sliced)."""
        return self.knot_models[t] if self.per_knot else self.running

    @property
    def state(self):
        # shapes (nx, nu, ...) come from one knot's leaves, not the stacks
        return self.knot_model(0).state

    @property
    def nu(self) -> int:
        return self.knot_model(0).nu

    def quasi_static(self, xs):
        """Warm-start controls ``[..., T, nu]`` for states ``[..., T, nx]``
        (the reference's ``problem.quasiStatic([x0] * T)``)."""
        if self.per_knot:
            return torch.stack([m.quasi_static(xs[..., t, :])
                                for t, m in enumerate(self.knot_models)], dim=-2)
        return self.running.quasi_static(xs)

    def rollout(self, us, x0=None):
        """Nonlinear rollout of controls ``[..., T, nu]`` -> xs ``[..., T+1, nx]``."""
        x = self.x0 if x0 is None else x0
        x = x.expand(us.shape[:-2] + x.shape[-1:])
        xs = [x]
        for t in range(self.T):
            x = self.knot_model(t).calc(x, us[..., t, :]).xnext
            xs.append(x)
        return torch.stack(xs, dim=-2)

    def calc_cost(self, xs, us):
        """Total trajectory cost of ``xs [..., T+1, nx]``, ``us [..., T, nu]``."""
        if self.per_knot:
            run = torch.stack([m.calc(xs[..., t, :], us[..., t, :]).cost
                               for t, m in enumerate(self.knot_models)], dim=-1)
        else:
            run = self.running.calc(xs[..., :-1, :], us).cost
        u0 = torch.zeros(us.shape[:-2] + (self.terminal.nu,), dtype=xs.dtype, device=xs.device)
        return run.sum(-1) + self.terminal.calc(xs[..., -1, :], u0).cost
