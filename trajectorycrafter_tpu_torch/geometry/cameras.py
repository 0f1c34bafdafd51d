"""Camera models and spherical pose synthesis.

Counterpart of trajectorycrafter_tpu/geometry/cameras.py.  Poses are a
handful of 4x4 matrices, so they are built on the host in float32 (the CPU
has no TF32, so the products are full fp32) and moved to the device by the
caller.

Conventions (the reference's):
  * camera-to-world matrices (c2w), right-multiplied homogeneous column points
  * initial camera: c2w0 = diag(-1, 1, -1, 1)
  * spherical parametrisation: translate -r along world z, pan by (x, y),
    then rotate theta about world x and phi about world y (left-multiplied).
"""

from __future__ import annotations

import numpy as np
import torch


def default_c2w() -> torch.Tensor:
    """Initial anchor camera pose."""
    return torch.diag(torch.tensor([-1.0, 1.0, -1.0, 1.0], dtype=torch.float32))


def intrinsics_matrix(f, cx, cy) -> torch.Tensor:
    """3x3 pinhole intrinsics (float32)."""
    return torch.tensor([[f, 0.0, cx], [0.0, f, cy], [0.0, 0.0, 1.0]], dtype=torch.float32)


def zoom_intrinsics(f0: float, f1: float, num: int, cx: float, cy: float) -> torch.Tensor:
    """(num, 3, 3) float32 intrinsics whose focal ramps linearly from f0 to
    f1 (the dolly zoom): the linspace taken in float64 and rounded once."""
    K = torch.zeros((num, 3, 3), dtype=torch.float32)
    K[:, 0, 0] = K[:, 1, 1] = torch.from_numpy(np.linspace(f0, f1, num).astype(np.float32))
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = cx, cy, 1.0
    return K


def _rot(angle: torch.Tensor, axis: str) -> torch.Tensor:
    """(n,) radians -> (n, 4, 4) rotations about world x or y."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    if axis == "x":
        rows = [[o, z, z, z], [z, c, -s, z], [z, s, c, z], [z, z, z, o]]
    else:
        rows = [[c, z, s, z], [z, o, z, z], [-s, z, c, z], [z, z, z, o]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def sphere2pose(c2w: torch.Tensor, theta_deg, phi_deg, r, x=None, y=None) -> torch.Tensor:
    """Spherical offsets of a (4, 4) c2w for (n,) angle/radius sequences -> (n, 4, 4).

    Ordering as the reference: translate z -= r (y += y-pan, x -= x-pan),
    then left-multiply rot_x(theta) and rot_y(phi).
    """
    as_f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32)).reshape(-1)
    theta = torch.deg2rad(as_f32(theta_deg))
    phi = torch.deg2rad(as_f32(phi_deg))
    n = theta.shape[0]
    poses = c2w.to(torch.float32).expand(n, 4, 4).clone()
    poses[:, 2, 3] -= as_f32(r)
    if y is not None:
        poses[:, 1, 3] += as_f32(y)
    if x is not None:
        poses[:, 0, 3] -= as_f32(x)
    poses = _rot(theta, "x") @ poses
    return _rot(phi, "y") @ poses


def pose_radius_from_depth(depth, radius_scale: float, max_radius: float = 5.0) -> float:
    """Orbit radius = centre-pixel depth of frame 0 x scale, clamped."""
    depth = np.asarray(depth)
    h, w = depth.shape[-2], depth.shape[-1]
    radius = float(depth[..., h // 2, w // 2].reshape(-1)[0]) * radius_scale
    return min(radius, max_radius)
