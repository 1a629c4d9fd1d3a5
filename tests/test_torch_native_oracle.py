"""The port's rigid-body dynamics against the independently written C++
oracle (``native/rbd_oracle.cpp`` through ``aslr_to_tpu_torch/utils/
native.py``), as JAX's ``tests/test_native_oracle.py`` holds the JAX
package's, float64 on the CPU, no JAX.

On ``double_pendulum``, ``asr_twodof`` and ``seven_dof_arm``, seeded numpy
inputs: RNEA (three draws) and nle to 1e-10, the mass matrix to 1e-10,
forward kinematics to 1e-12 (the JAX test's tolerances), and ``aba``
against the oracle's M and RNEA (solve M a = tau - nle) to 1e-9. The
oracle's library is built by g++ into the git-ignored ``build/`` directory;
``native/librbd_oracle.so`` is read by neither package's call here and
keeps its bytes.
"""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from aslr_to_tpu_torch.models import robots
from aslr_to_tpu_torch.ops import rigid_body as rbd
from aslr_to_tpu_torch.utils import native

TRACKED_SO = Path(__file__).resolve().parents[1] / "native" / "librbd_oracle.so"


def _digest():
    return hashlib.sha256(TRACKED_SO.read_bytes()).hexdigest()


@pytest.fixture(params=["double_pendulum", "asr_twodof", "seven_dof_arm"])
def robot(request):
    return robots.load(request.param)


def _draw(robot, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((4, robot.nv)) for _ in range(n)]


def test_rnea_matches_native(robot):
    for seed in range(3):
        q, v, a = _draw(robot, seed)
        tau = rbd.rnea(robot, *map(torch.tensor, (q, v, a))).numpy()
        np.testing.assert_allclose(tau, native.rnea(robot, q, v, a).numpy(), atol=1e-10)


def test_mass_matrix_matches_native(robot):
    q, = _draw(robot, 5, 1)
    np.testing.assert_allclose(rbd.mass_matrix(robot, torch.tensor(q)).numpy(),
                               native.mass_matrix(robot, q).numpy(), atol=1e-10)


def test_fk_matches_native(robot):
    q, = _draw(robot, 6, 1)
    rots, trans = rbd.forward_kinematics(robot, torch.tensor(q))
    rots_c, trans_c = native.fk(robot, q)
    np.testing.assert_allclose(rots.numpy(), rots_c.numpy(), atol=1e-12)
    np.testing.assert_allclose(trans.numpy(), trans_c.numpy(), atol=1e-12)


def test_nle_matches_native(robot):
    q, v = _draw(robot, 7, 2)
    nle = rbd.nonlinear_effects(robot, torch.tensor(q), torch.tensor(v)).numpy()
    np.testing.assert_allclose(nle, native.rnea(robot, q, v, np.zeros_like(q)).numpy(),
                               atol=1e-10)


def test_aba_matches_native(robot):
    q, v, tau = _draw(robot, 8)
    acc = rbd.aba(robot, *map(torch.tensor, (q, v, tau))).numpy()
    M = native.mass_matrix(robot, q).numpy()
    nle = native.rnea(robot, q, v, np.zeros_like(q)).numpy()
    want = np.linalg.solve(M, (tau - nle)[..., None])[..., 0]
    np.testing.assert_allclose(acc, want, atol=1e-9)


def test_oracle_builds_outside_native_and_leaves_the_tracked_library():
    """The port's oracle library lies in the git-ignored build directory, and
    a build and calls through it leave ``native/librbd_oracle.so`` as it
    was, byte for byte."""
    before = _digest()
    path = native.library_path()
    assert path.parent.parts[-2:] == ("build", "aslr_to_tpu_torch")
    assert path.resolve() != TRACKED_SO.resolve()
    robot = robots.load("double_pendulum")
    q = np.array([[0.3, -0.2]])
    native.rnea(robot, q, q, q)
    assert path.exists()
    assert _digest() == before
