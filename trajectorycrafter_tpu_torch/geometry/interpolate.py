"""Smooth camera paths: quaternion SLERP of poses, linear interpolation of
intrinsics.

Counterpart of trajectorycrafter_tpu/geometry/interpolate.py (the reference's
smooth known-pose variant, run_w_cam_poses_mvtracker_smooth.py): rotations
are interpolated as unit quaternions along the shortest arc, translations
and intrinsics linearly, over ``num_steps`` alphas i / (num_steps - 1).
Everything is float32 and vectorised over the steps, as in the JAX module.
"""

from __future__ import annotations

import numpy as np
import torch


def _f32(x) -> torch.Tensor:
    return x.float() if torch.is_tensor(x) else torch.from_numpy(np.asarray(x, np.float32))


def mat_to_quat(R) -> torch.Tensor:
    """Rotation matrix -> unit quaternion [w, x, y, z], (..., 3, 3) -> (..., 4).

    All four Shepperd candidates are computed (each stable where its own
    pivot 4w^2, 4x^2, 4y^2 or 4z^2 is the largest) and the one of the largest
    pivot is taken, the first on a tie.
    """
    R = _f32(R)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    # squared pivots 4w^2, 4x^2, 4y^2, 4z^2, clamped at 0
    qw2 = torch.clamp(1.0 + m00 + m11 + m22, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)

    def pivot(s):
        return 2.0 * torch.sqrt(torch.where(s > 0.0, s, torch.ones_like(s)))

    sw, sx, sy, sz = pivot(qw2), pivot(qx2), pivot(qy2), pivot(qz2)
    cand = torch.stack([
        torch.stack([0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], -1),
        torch.stack([(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx], -1),
        torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy], -1),
        torch.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz], -1),
    ], -2)  # (..., 4 candidates, 4)
    pick = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], -1), dim=-1)
    q = torch.take_along_dim(cand, pick[..., None, None].expand(*pick.shape, 1, 4),
                             dim=-2)[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_mat(q) -> torch.Tensor:
    """Unit quaternion [w, x, y, z] -> rotation matrix, (..., 4) -> (..., 3, 3)."""
    q = _f32(q)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def slerp(q0, q1, alphas) -> torch.Tensor:
    """Shortest-arc spherical interpolation of two quaternions at (n,)
    ``alphas`` -> (n, 4): q1 is negated when the two lie in opposite
    hemispheres, and nearly parallel ones (|dot| > 0.9995) are lerped and
    normalised."""
    q0, q1, alphas = _f32(q0), _f32(q1), _f32(alphas)
    dot = torch.sum(q0 * q1)
    q1 = torch.where(dot < 0.0, -q1, q1)
    dot = torch.abs(dot)

    lerped = q0[None] + alphas[:, None] * (q1 - q0)[None]
    lerped = lerped / torch.linalg.norm(lerped, dim=-1, keepdim=True)

    theta0 = torch.arccos(torch.clamp(dot, 0.0, 1.0))
    sin0 = torch.clamp(torch.sin(theta0), min=1e-12)
    theta = theta0 * alphas
    s0 = torch.cos(theta) - dot * torch.sin(theta) / sin0
    s1 = torch.sin(theta) / sin0
    slerped = s0[:, None] * q0[None] + s1[:, None] * q1[None]
    return torch.where(dot > 0.9995, lerped, slerped)


def _alphas(num_steps: int) -> torch.Tensor:
    """i / (num_steps - 1), each correctly rounded to float32 (``jnp.linspace``
    may sit an ulp off it); one step is alpha 0."""
    i = torch.arange(num_steps, dtype=torch.float32)
    return i / (num_steps - 1) if num_steps > 1 else i


def interpolate_poses(source, target, num_steps: int) -> torch.Tensor:
    """(4, 4), (4, 4) -> (num_steps, 4, 4) float32: the rotation block
    SLERPed, the translation lerped; the ends are the inputs."""
    source, target = _f32(source), _f32(target)
    alphas = _alphas(num_steps)
    R = quat_to_mat(slerp(mat_to_quat(source[:3, :3]), mat_to_quat(target[:3, :3]), alphas))
    t = (1.0 - alphas)[:, None] * source[:3, 3][None] + alphas[:, None] * target[:3, 3][None]
    out = torch.eye(4, dtype=torch.float32).repeat(num_steps, 1, 1)
    out[:, :3, :3] = R
    out[:, :3, 3] = t
    return out


def interpolate_intrinsics(source_K, target_K, num_steps: int) -> torch.Tensor:
    """(3, 3), (3, 3) -> (num_steps, 3, 3) float32 linear interpolation."""
    source_K, target_K = _f32(source_K), _f32(target_K)
    alphas = _alphas(num_steps)
    return (1.0 - alphas)[:, None, None] * source_K[None] + \
        alphas[:, None, None] * target_K[None]
