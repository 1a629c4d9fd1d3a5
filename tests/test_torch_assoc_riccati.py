"""The log-depth Riccati backward of the port
(``aslr_to_tpu_torch/solvers/assoc_riccati.py``) against the JAX package's
``fddp_backward_assoc`` and its sequential ``_fddp_backward_scan`` on the
same inputs (``tests/test_assoc_riccati.py::_random_lqr``'s structure, made
with numpy from a seed), in f64 to rtol and atol 1e-8 with equal flags; a
batch whose lanes differ; a knot whose factor fails; and full solves with
``assoc_backward`` on the generic and fast routes against the port's own
sequential backward (held to JAX by the solver tests), with the refusals.
"""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aslr_to_tpu.solvers import ddp as D
from aslr_to_tpu.solvers.assoc_riccati import fddp_backward_assoc as jax_assoc
from aslr_to_tpu_torch import SolverSettings, make_batched_solver, solve
from aslr_to_tpu_torch import two_dof_sea, two_dof_vsa_boxddp
from aslr_to_tpu_torch.solvers.assoc_riccati import fddp_backward_assoc, reverse_scan

NAMES = ["k", "K", "w", "dg", "dq", "stop", "dg_gap", "dq_gap", "ok", "retryable"]


def _random_lqr(T, ndx, nu, seed, gaps=True):
    """Near-identity dynamics and SPD-ish cost blocks, as the solver's
    recursion sees them (Euler integrators, quadratic costs)."""
    rng = np.random.default_rng(seed)
    n = rng.standard_normal
    Fx = np.eye(ndx) + 0.05 * n((T, ndx, ndx))
    Fu = 0.1 * n((T, ndx, nu))
    Lx = n((T, ndx))
    Lu = n((T, nu))
    W = 0.3 * n((T, ndx, ndx))
    Lxx = W @ W.swapaxes(-1, -2) + 0.5 * np.eye(ndx)
    Wu = 0.3 * n((T, nu, nu))
    Luu = Wu @ Wu.swapaxes(-1, -2) + 0.5 * np.eye(nu)
    Lxu = 0.05 * n((T, ndx, nu))
    tLx = n(ndx)
    Wt = 0.3 * n((ndx, ndx))
    tLxx = Wt @ Wt.T + 0.5 * np.eye(ndx)
    fs = 0.1 * n((T + 1, ndx)) if gaps else np.zeros((T + 1, ndx))
    return Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, tLx, tLxx, fs


def _check_lane(port, lane, refs):
    """Lane ``lane`` of the port's outputs against each JAX output tuple."""
    for ref in refs:
        for name, p, r in zip(NAMES, port, ref):
            p, r = p[lane].numpy(), np.asarray(r)
            if r.dtype == bool:
                assert np.array_equal(p, r), name
            else:
                np.testing.assert_allclose(p, r, rtol=1e-8, atol=1e-8, equal_nan=True,
                                           err_msg=name)


_JAX = (jax.jit(D._fddp_backward_scan), jax.jit(jax_assoc))


def _jax_refs(args, reg):
    """JAX's sequential and associative backwards of one lane's inputs."""
    jargs = [jnp.asarray(a) for a in args] + [jnp.asarray(reg)]
    return tuple(f(*jargs) for f in _JAX)


@pytest.mark.parametrize("T,gaps,reg", [(7, True, 1e-6), (32, True, 1e-3),
                                        (33, False, 1e-9), (100, True, 1e-6)])
def test_assoc_backward_matches_jax(T, gaps, reg):
    args = _random_lqr(T, 8, 4, seed=T, gaps=gaps)
    port = fddp_backward_assoc(*(torch.tensor(a)[None] for a in args),
                               torch.tensor([reg], dtype=torch.float64))
    _check_lane(port, 0, _jax_refs(args, reg))
    assert bool(port[8][0]) and not bool(port[9][0])


def test_assoc_backward_batched_lanes_match_jax():
    """B=3 lanes with their own data, horizon-long gaps and regularization:
    each lane equals JAX's solve of its own inputs."""
    lanes = [_random_lqr(21, 8, 4, seed=s, gaps=s != 1) for s in range(3)]
    regs = [1e-6, 1e-3, 1e-9]
    port = fddp_backward_assoc(*(torch.tensor(np.stack(a)) for a in zip(*lanes)),
                               torch.tensor(regs, dtype=torch.float64))
    for b, (args, reg) in enumerate(zip(lanes, regs)):
        _check_lane(port, b, _jax_refs(args, reg))


def test_assoc_backward_failed_factor_gives_jax_flags():
    """Knot 3's Luu made indefinite: its Cholesky factor fails, so ``ok`` is
    false and ``retryable`` true (Quu finite), with the JAX package's NaNs
    at that knot and its values elsewhere."""
    args = list(_random_lqr(9, 8, 4, seed=5))
    args[6] = args[6].copy()
    args[6][3] = -40.0 * np.eye(4)
    port = fddp_backward_assoc(*(torch.tensor(a)[None] for a in args),
                               torch.tensor([1e-6], dtype=torch.float64))
    refs = _jax_refs(args, 1e-6)
    assert not bool(port[8][0]) and bool(port[9][0])
    assert bool(port[0][0, 3].isnan().all()) and bool(torch.isfinite(port[0][0, 4:]).all())
    _check_lane(port, 0, refs[1:])


def test_reverse_scan_spans_every_suffix():
    """The scan composes exactly elements t .. n-1 at index t, for every n
    from 1 to 40 (odd, even, powers of two), the later part first."""
    def combine(later, earlier):
        assert torch.equal(earlier[1], later[0])
        return earlier[0], later[1]

    for n in range(1, 41):
        start = torch.arange(n, dtype=torch.float64)[None]
        lo, hi = reverse_scan(combine, (start, start + 1))
        assert torch.equal(lo, start) and bool((hi == n).all()), n


@pytest.fixture(scope="module")
def sea():
    w = two_dof_sea(T=20, device="cpu")
    rng = np.random.default_rng(2)
    return w.problem, torch.tensor(0.1 * rng.standard_normal((3, 8)))


@pytest.mark.parametrize("route", ["generic", "fast"])
@pytest.mark.parametrize("family", ["fddp", "ddp"])
def test_assoc_solve_matches_sequential_backward(sea, route, family):
    """The SEA solve (T=20, maxiter 8, f64) with ``assoc_backward`` against
    the same route with the sequential backward (the fast route's plain
    versions on the CPU): equal iterations and flags, cost within rtol 1e-9,
    us within atol 1e-7, on every lane."""
    problem, x0s = sea
    use_gaps = family == "fddp"

    def run(assoc):
        settings = SolverSettings(maxiter=8, th_stop=1e-9, assoc_backward=assoc)
        return make_batched_solver(problem, settings, use_gaps=use_gaps,
                                   use_fast_path=route == "fast")(x0s)

    seq, par = run(False), run(True)
    for name in ("iterations", "converged", "diverged"):
        assert torch.equal(getattr(seq, name), getattr(par, name)), name
    np.testing.assert_allclose(par.cost.numpy(), seq.cost.numpy(), rtol=1e-9)
    np.testing.assert_allclose(par.us.numpy(), seq.us.numpy(), atol=1e-7)
    assert int(seq.iterations.min()) >= 2


def test_assoc_refuses_bounds_and_the_lane_route():
    """A box raises ``ValueError`` naming assoc_backward, on the generic and
    fast routes (no sequential fallback), and the lane route refuses the
    setting when it is built."""
    w = two_dof_vsa_boxddp(T=6, device="cpu")
    settings = SolverSettings(maxiter=2, assoc_backward=True)
    with pytest.raises(ValueError, match="assoc_backward"):
        solve(dataclasses.replace(w.problem, x0=w.problem.x0[None]), settings=settings,
              use_gaps=False, bounds=w.bounds)
    fast = make_batched_solver(w.problem, settings, use_gaps=False, bounds=w.bounds,
                               use_fast_path=True)
    with pytest.raises(ValueError, match="assoc_backward"):
        fast(w.problem.x0[None])
    for bounds in (w.bounds, None):
        with pytest.raises(ValueError, match="assoc_backward"):
            make_batched_solver(w.problem, settings, use_gaps=bounds is None, bounds=bounds,
                                use_fast_path="lanes")
