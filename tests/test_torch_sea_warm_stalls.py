"""The SEA warm re-solve's lanes that stalled on the card, solved again on
the CPU by the port's plain versions and by the JAX package.

``tests/data_torch/sea_warm_stalled_lanes.npz`` holds 12 lanes of the first
timed re-solve of ``aslr_to_tpu_torch/measure.py``'s ``sea_warm`` path
(two_dof_sea, T=100, B=4096, float32, FDDP, maxiter=60, th_stop=1e-5) as the
CUDA kernels ran it on an NVIDIA H100 80GB HBM3 (700 W): the 6 lanes that
ran to maxiter unconverged and the first 6 that converged, each with its
inputs (x0 and the cold solve's xs, us) and the card's results. Made with
``python -m aslr_to_tpu_torch.measure --path sea_warm --batch 4096
--save-lanes FILE``.

- In float64 the port and the JAX package (``jit(vmap(solve))``) agree lane
  by lane and converge every lane within 3 iterations: the stalls are not a
  property of these scenarios.
- In float32 which lanes stall depends on rounding. The JAX package's own
  float32 solve stalls on some of the lanes that stalled on the card, and
  both solvers converge every lane that converged there.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aslr_to_tpu.solvers.ddp import SolverSettings as JaxSettings
from aslr_to_tpu.solvers.ddp import solve as jax_solve
from aslr_to_tpu.workloads.presets import two_dof_sea as jax_sea
from aslr_to_tpu_torch import SolverSettings, make_batched_solver, two_dof_sea
from aslr_to_tpu_torch.kernels import build

DATA = np.load(os.path.join(os.path.dirname(__file__), "data_torch",
                            "sea_warm_stalled_lanes.npz"))
SETTINGS = dict(maxiter=60, th_stop=1e-5)
N_STALLED = int(DATA["n_stuck"])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def solve_both(dtype_name):
    """(port, jax) results of the warm re-solve of the saved lanes."""
    tdt, jdt = getattr(torch, dtype_name), getattr(jnp, dtype_name)
    args = [DATA[k] for k in ("x0s", "xs_init", "us_init")]
    w = two_dof_sea(T=100, dtype=tdt, device="cpu")
    solve = make_batched_solver(w.problem, SolverSettings(**SETTINGS), use_gaps=True,
                                bounds=None, use_fast_path="lanes")
    build.reset_launches()
    port = solve(*(torch.tensor(a, dtype=tdt) for a in args))
    assert sum(build.LAUNCHES.values()) == 0

    wj = jax_sea(T=100, dtype=jdt)

    def one(x0, xs, us):
        return jax_solve(dataclasses.replace(wj.problem, x0=x0), xs, us,
                         settings=JaxSettings(**SETTINGS), use_gaps=True, bounds=None)

    ref = jax.jit(jax.vmap(one))(*(jnp.asarray(a, dtype=jdt) for a in args))
    def row(it, conv, div):
        return f"{np.asarray(it).tolist()} {np.asarray(conv).astype(int).tolist()} " \
               f"{np.asarray(div).astype(int).tolist()}"

    print(f"\n{dtype_name} iterations / converged / diverged, lane by lane:"
          f"\n  card (f32) {row(DATA['iterations'], DATA['converged'], DATA['diverged'])}"
          f"\n  port       {row(port.iterations, port.converged, port.diverged)}"
          f"\n  jax        {row(ref.iterations, ref.converged, ref.diverged)}")
    return port, ref


def test_saved_lanes_are_the_cards_stalls():
    it, conv = DATA["iterations"], DATA["converged"]
    assert N_STALLED == 6
    assert (it[:N_STALLED] == SETTINGS["maxiter"]).all() and not conv[:N_STALLED].any()
    assert conv[N_STALLED:].all() and not DATA["diverged"].any()


def test_stalled_lanes_converge_in_float64_as_in_jax():
    port, ref = solve_both("float64")
    np.testing.assert_array_equal(port.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(port.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_array_equal(port.diverged.numpy(), np.asarray(ref.diverged))
    assert np.allclose(port.cost.numpy(), np.asarray(ref.cost), rtol=1e-8)
    assert np.allclose(port.xs.numpy(), np.asarray(ref.xs), atol=1e-8)
    assert np.allclose(port.us.numpy(), np.asarray(ref.us), atol=1e-8)
    assert port.converged.all() and int(port.iterations.max()) <= 3


def test_float32_stalls_depend_on_rounding():
    port, ref = solve_both("float32")
    jax_conv = np.asarray(ref.converged)
    # the reference's own float32 arithmetic stalls on some of the card's
    # stalled lanes too
    assert not jax_conv[:N_STALLED].all()
    # and neither solver stalls where the card converged
    assert jax_conv[N_STALLED:].all() and port.converged[N_STALLED:].all()
