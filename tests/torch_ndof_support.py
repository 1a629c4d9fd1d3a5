"""The n-DoF solves of the port against the JAX package's generic solve,
shared by ``test_torch_ndof.py``, ``test_torch_ndof_seven.py``,
``test_torch_ndof_box.py`` and ``test_torch_ndof_box_seven.py``.

``jax_reference`` compiles the JAX generic ``jit(vmap(solve))`` of a preset
once for a cold and a warm-started half; ``check_solve`` runs the port's
lane or fast route on CPU tensors and holds it to one half: iterations,
converged and diverged equal, cost to rtol 1e-10, xs and us to atol 1e-10
(as ``tests/test_lane_solver.py:376-405``). ``box_reference`` and
``check_box_solve`` do the same for DDP and for BoxFDDP in a shared box,
the JAX solve compiled once for every preset and box of one structure (it
takes the problem and the bounds as arguments). ``one_thread``, imported
into a test module, runs its tests on one torch thread.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aslr_to_tpu.solvers.ddp import Bounds as JaxBounds
from aslr_to_tpu.solvers.ddp import SolverSettings as JaxSettings
from aslr_to_tpu.solvers.ddp import solve as jax_solve
from aslr_to_tpu.workloads import presets as jpresets
from aslr_to_tpu_torch import Bounds, SolverSettings, make_batched_solver, seven_dof_sea
from aslr_to_tpu_torch import three_dof_sea
from aslr_to_tpu_torch.kernels import build

PRESETS = {"three_dof_sea": (jpresets.three_dof_sea, three_dof_sea, 3),
           "seven_dof_sea": (jpresets.seven_dof_sea, seven_dof_sea, 7)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x0s(nl, n, seed):
    return 0.1 * np.random.default_rng(seed).standard_normal((n, 4 * nl))


def jax_reference(preset, T, B, settings):
    """The JAX generic solve of B states cold, then of the same B states
    warm-started from the quasi-static controls (a cold start is zero
    controls), as one compiled vmap(solve) over 2 B lanes."""
    jfn, _, nl = PRESETS[preset]
    problem, st = jfn(T=T).problem, JaxSettings(**settings)

    def one(x0, warm):
        p = dataclasses.replace(problem, x0=x0)
        xs0 = jnp.broadcast_to(x0, (T + 1,) + x0.shape)
        us0 = jnp.where(warm, p.quasi_static(xs0[:-1]), 0.0)
        return jax_solve(p, xs0, us0, settings=st, use_gaps=True, bounds=None)

    x0s = np.concatenate([_x0s(nl, B, nl)] * 2)
    return jax.jit(jax.vmap(one))(jnp.asarray(x0s), jnp.asarray(np.arange(2 * B) >= B))


def check_solve(preset, T, B, settings, warm, route, reference):
    """The port's solve (``route``: "lanes" or True, the fast route) of the
    B states on CPU tensors against the cold or the warm half of
    ``reference``."""
    _, tfn, nl = PRESETS[preset]
    ref = jax.tree.map(lambda a: np.asarray(a)[B:] if warm else np.asarray(a)[:B], reference)
    solve = make_batched_solver(tfn(T=T, device="cpu").problem, SolverSettings(**settings),
                                use_gaps=True, bounds=None, warm_start=warm, use_fast_path=route)
    build.reset_launches()
    res = solve(torch.tensor(_x0s(nl, B, nl)))
    assert sum(build.LAUNCHES.values()) == 0      # CPU tensors: the plain versions
    np.testing.assert_array_equal(res.iterations.numpy(), ref.iterations)
    np.testing.assert_array_equal(res.converged.numpy(), ref.converged)
    np.testing.assert_array_equal(res.diverged.numpy(), ref.diverged)
    np.testing.assert_allclose(res.cost.numpy(), ref.cost, rtol=1e-10, atol=0)
    np.testing.assert_allclose(res.us.numpy(), ref.us, atol=1e-10, rtol=0)
    np.testing.assert_allclose(res.xs.numpy(), ref.xs, atol=1e-10, rtol=0)
    assert np.allclose(res.stop.numpy(), ref.stop, rtol=1e-8)
    assert int(res.iterations.max()) >= 2      # the loop ran past its first pass


@partial(jax.jit, static_argnames=("settings", "use_gaps"))
def _jax_box_solve(problem, bounds, x0s, warm, settings, use_gaps):
    """The JAX generic solve of ``problem`` from each x0, warm-started from
    the quasi-static controls where ``warm`` (projected into the box by the
    solve), else cold: one compile for every problem of a structure."""
    def one(x0, w):
        p = dataclasses.replace(problem, x0=x0)
        xs0 = jnp.broadcast_to(x0, (p.T + 1,) + x0.shape)
        us0 = jnp.where(w, p.quasi_static(xs0[:-1]), 0.0)
        return jax_solve(p, xs0, us0, settings=settings, use_gaps=use_gaps, bounds=bounds)
    return jax.vmap(one)(x0s, warm)


def box_reference(preset, T, B, settings, use_gaps, box):
    """The JAX generic solve of B states cold, then of the same B warm, in
    the shared box ``box`` ((lb, ub), each [nu]; None: no box) with
    ``use_gaps``: DDP (False, no box) or BoxFDDP (True, a box)."""
    jfn, _, nl = PRESETS[preset]
    bounds = None if box is None else JaxBounds(*(jnp.asarray(b) for b in box))
    x0s = np.concatenate([_x0s(nl, B, nl)] * 2)
    return _jax_box_solve(jfn(T=T).problem, bounds, jnp.asarray(x0s),
                          jnp.asarray(np.arange(2 * B) >= B), JaxSettings(**settings), use_gaps)


def check_box_solve(preset, T, B, settings, use_gaps, box, warm, route, reference, atol):
    """The port's solve (``route`` "lanes" or True) of the B states on CPU
    tensors against the cold or warm half of ``reference``: iterations and
    flags equal, cost to rtol 1e-10, xs and us to ``atol``. Returns the
    port's result."""
    _, tfn, nl = PRESETS[preset]
    ref = jax.tree.map(lambda a: np.asarray(a)[B:] if warm else np.asarray(a)[:B], reference)
    bounds = None if box is None else Bounds(*(torch.tensor(b, dtype=torch.float64)
                                               for b in box))
    solve = make_batched_solver(tfn(T=T, device="cpu").problem, SolverSettings(**settings),
                                use_gaps=use_gaps, bounds=bounds, warm_start=warm,
                                use_fast_path=route)
    build.reset_launches()
    res = solve(torch.tensor(_x0s(nl, B, nl)))
    assert sum(build.LAUNCHES.values()) == 0      # CPU tensors: the plain versions
    np.testing.assert_array_equal(res.iterations.numpy(), ref.iterations)
    np.testing.assert_array_equal(res.converged.numpy(), ref.converged)
    np.testing.assert_array_equal(res.diverged.numpy(), ref.diverged)
    np.testing.assert_allclose(res.cost.numpy(), ref.cost, rtol=1e-10, atol=0)
    np.testing.assert_allclose(res.us.numpy(), ref.us, atol=atol, rtol=0)
    np.testing.assert_allclose(res.xs.numpy(), ref.xs, atol=atol, rtol=0)
    assert int(res.iterations.max()) >= 2      # the loop ran past its first pass
    return res
