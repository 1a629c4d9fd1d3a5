"""The port's URDF parser and trajectory io (``aslr_to_tpu_torch/utils/
urdf.py``, ``io.py``), float64 on the CPU.

- ``parse_urdf`` on a URDF of the registry double pendulum (this file's own
  copy of the one in JAX's ``tests/test_urdf.py``): M, nle, RNEA and the
  tip's placement equal the registry robot's to 1e-12, and every model
  array equals the one JAX's ``parse_urdf`` gives; ``dtype`` and
  ``device``; the rpy case (the rotation of joint 1 to 1e-12); a fixed
  joint's frames; a prismatic joint refused;
- ``save_solution`` / ``load_solution`` round trip (tensors back, the bits
  kept) and ``export_mat`` (read back with scipy).
"""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest
import torch

from aslr_to_tpu.utils.urdf import parse_urdf as jax_parse_urdf
from aslr_to_tpu_torch.models import robots
from aslr_to_tpu_torch.ops import rigid_body as rbd
from aslr_to_tpu_torch.utils import io
from aslr_to_tpu_torch.utils.urdf import parse_urdf

URDF = """
<robot name="double_pendulum">
  <link name="base_link"/>
  <joint name="joint1" type="revolute">
    <parent link="base_link"/><child link="link1"/>
    <origin xyz="0 0 0.1"/><axis xyz="0 1 0"/>
    <limit lower="-3.14" upper="3.14" effort="10" velocity="10"/>
  </joint>
  <link name="link1">
    <inertial>
      <origin xyz="0 0 0.1"/>
      <mass value="0.3"/>
      <inertia ixx="0.001" iyy="0.001" izz="1e-5" ixy="0" ixz="0" iyz="0"/>
    </inertial>
  </link>
  <joint name="joint2" type="continuous">
    <parent link="link1"/><child link="link2"/>
    <origin xyz="0 0 0.2"/><axis xyz="0 1 0"/>
  </joint>
  <link name="link2">
    <inertial>
      <origin xyz="0 0 0.1"/>
      <mass value="0.3"/>
      <inertia ixx="0.001" iyy="0.001" izz="1e-5" ixy="0" ixz="0" iyz="0"/>
    </inertial>
  </link>
  <joint name="tip_joint" type="fixed">
    <parent link="link2"/><child link="tip"/>
    <origin xyz="0 0 0.2"/>
  </joint>
  <link name="tip"/>
</robot>
"""

FIELDS = ("joint_rot", "joint_pos", "axis", "mass", "com", "inertia", "frame_rot", "frame_pos",
          "gravity")


def test_urdf_matches_registry_double_pendulum(tmp_path):
    parsed = parse_urdf(URDF)
    reg = robots.double_pendulum()
    q, v, a = (torch.tensor(x, dtype=torch.float64) for x in
               ([[0.4, -0.9]], [[0.3, 0.8]], [[-0.2, 0.5]]))
    for fn, args in ((rbd.mass_matrix, (q,)), (rbd.nonlinear_effects, (q, v)),
                     (rbd.rnea, (q, v, a))):
        np.testing.assert_allclose(fn(parsed, *args).numpy(), fn(reg, *args).numpy(), atol=1e-12)
    tip_p = rbd.frame_placement(parsed, q, parsed.frame_id("tip"))
    tip_r = rbd.frame_placement(reg, q, reg.frame_id("tip"))
    np.testing.assert_allclose(tip_p.trans.numpy(), tip_r.trans.numpy(), atol=1e-12)
    np.testing.assert_allclose(tip_p.rot.numpy(), tip_r.rot.numpy(), atol=1e-12)
    # from a file too
    f = tmp_path / "pendulum.urdf"
    f.write_text(URDF)
    assert parse_urdf(str(f)).frame_names == parsed.frame_names


def test_urdf_matches_jax_parser():
    got, want = parse_urdf(URDF), jax_parse_urdf(URDF)
    assert (got.name, got.parents, got.frame_names, got.frame_parents) == (
        want.name, want.parents, want.frame_names, want.frame_parents)
    assert got.frame_names == ("link1", "link2", "tip_joint", "tip")
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                      err_msg=field)
    f32 = parse_urdf(URDF, gravity=(9.81, 0.0, 0.0), dtype=torch.float32, device="cpu")
    assert f32.mass.dtype == f32.gravity.dtype == torch.float32
    assert np.allclose(f32.gravity.tolist(), [9.81, 0.0, 0.0])


def test_urdf_rpy_origin():
    urdf = URDF.replace('<origin xyz="0 0 0.1"/><axis xyz="0 1 0"/>',
                        '<origin xyz="0 0 0.1" rpy="0 0 1.57"/><axis xyz="0 1 0"/>', 1)
    R0 = parse_urdf(urdf).joint_rot[0].numpy()
    assert np.allclose(R0[0, 0], np.cos(1.57), atol=1e-12)
    assert np.allclose(R0[1, 0], np.sin(1.57), atol=1e-12)
    np.testing.assert_array_equal(R0, np.asarray(jax_parse_urdf(urdf).joint_rot[0]))


def test_urdf_refuses_a_prismatic_joint():
    with pytest.raises(ValueError, match="unsupported joint type 'prismatic'"):
        parse_urdf(URDF.replace('type="continuous"', 'type="prismatic"'))


def test_solution_round_trip_and_mat_export(tmp_path):
    rng = np.random.default_rng(0)
    xs = torch.tensor(rng.standard_normal((11, 8)))
    us = torch.tensor(rng.standard_normal((10, 2)), dtype=torch.float32)
    path = tmp_path / "sol.npz"
    io.save_solution(str(path), xs, us, dt=0.01, extra=dict(cost=torch.tensor(3.5)))
    xs2, us2 = io.load_solution(str(path))
    assert isinstance(xs2, torch.Tensor) and torch.equal(xs2, xs) and torch.equal(us2, us)
    with np.load(path) as f:
        assert float(f["dt"]) == 0.01 and float(f["cost"]) == 3.5
    from scipy.io import loadmat

    mat = tmp_path / "sol.mat"
    io.export_mat(str(mat), xs, us, 0.01)
    m = loadmat(str(mat))
    np.testing.assert_allclose(m["t"].ravel(), np.arange(10) * 0.01)
    np.testing.assert_array_equal(m["q1"].ravel(), xs[:10, 0].numpy())
    np.testing.assert_array_equal(m["q2"].ravel(), xs[:10, 1].numpy())
    np.testing.assert_array_equal(m["u2"].ravel(), us[:, 1].numpy())
