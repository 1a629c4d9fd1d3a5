"""Per-knot tables for the kernel tests: a target table and box tables
whose rows all differ, so that a lane that reads another knot's row gives
another result."""
import numpy as np
import torch

from aslr_to_tpu_torch.kernels import vsa_kernels

TIGHT_BOX = (np.array([-2.0, -2.0, 0.0, 0.0]), np.array([2.0, 2.0, 3.0, 3.0]))


def _rot(axis, angle):
    a = np.asarray(axis, dtype=float) / np.linalg.norm(axis)
    K = np.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]], [-a[1], a[0], 0.0]])
    return np.eye(3) + np.sin(angle) * K + (1.0 - np.cos(angle)) * K @ K


def per_knot_target(spec, T, dtype):
    """``spec`` with a target a knot (knot t's goal turned by 0.1 + 0.05 t
    about a tilted axis, its position on an arc; the terminal target kept)
    and its ``[T, 12]`` table in ``dtype``."""
    rot = np.stack([_rot([0.3, -0.2, 1.0], 0.1 + 0.05 * t) for t in range(T)])
    pos = np.stack([[0.01, 0.05 + 0.03 * t, 0.18 - 0.01 * t] for t in range(T)])
    term_rinv, term_pos = vsa_kernels._term_target(spec)
    pk = spec._replace(target_rot_inv=np.swapaxes(rot, 1, 2), target_pos=pos,
                       term_target_rot_inv=np.asarray(term_rinv),
                       term_target_pos=np.asarray(term_pos))
    return pk, torch.tensor(pk.target_table(T, dtype))


def box_tables(T, nu, dtype, pinch=None):
    """``[T, nu]`` lb and ub: the tight box (its first nu entries) widened
    by 10% a knot, with knot ``pinch``'s torques held to +-0.05."""
    lb = np.stack([TIGHT_BOX[0][:nu] * (1.0 + 0.1 * t) for t in range(T)])
    ub = np.stack([TIGHT_BOX[1][:nu] * (1.0 + 0.1 * t) for t in range(T)])
    if pinch is not None:
        lb[pinch, :2], ub[pinch, :2] = -0.05, 0.05
    return torch.tensor(lb, dtype=dtype), torch.tensor(ub, dtype=dtype)
