"""Rotation representation conversions (fp32 geometry).

Conventions match pytorch3d: quaternions are (w, x, y, z), matrices act on
column vectors, 6D rotations are the first two rows of the matrix. All
functions work on the last axis/axes and broadcast over leading dims.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(x, dim=-1, keepdim=True)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3), with a Taylor small-angle branch."""
    sq = (axis_angle * axis_angle).sum(-1, keepdim=True)
    small = sq < 1e-12
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    x, y, z = axis_angle.unbind(-1)
    zeros = torch.zeros_like(x)
    Kf = torch.stack([torch.stack([zeros, -z, y], -1),
                      torch.stack([z, zeros, -x], -1),
                      torch.stack([-y, x, zeros], -1)], -2)
    a = angle[..., None]
    K = Kf / a
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device)
    eye = eye.expand(Kf.shape)
    R = eye + torch.sin(a) * K + (1.0 - torch.cos(a)) * (K @ K)
    R_small = eye + Kf + 0.5 * (Kf @ Kf)
    return torch.where(small[..., None], R_small, R)


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) wxyz with w >= 0 (largest-pivot selection)."""
    m = matrix
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    zero = torch.zeros_like(m00)
    qw2 = torch.maximum(zero, 1.0 + m00 + m11 + m22)
    qx2 = torch.maximum(zero, 1.0 + m00 - m11 - m22)
    qy2 = torch.maximum(zero, 1.0 - m00 + m11 - m22)
    qz2 = torch.maximum(zero, 1.0 - m00 - m11 + m22)
    cand_w = torch.stack([qw2, m[..., 2, 1] - m[..., 1, 2],
                          m[..., 0, 2] - m[..., 2, 0],
                          m[..., 1, 0] - m[..., 0, 1]], -1)
    cand_x = torch.stack([m[..., 2, 1] - m[..., 1, 2], qx2,
                          m[..., 1, 0] + m[..., 0, 1],
                          m[..., 0, 2] + m[..., 2, 0]], -1)
    cand_y = torch.stack([m[..., 0, 2] - m[..., 2, 0],
                          m[..., 1, 0] + m[..., 0, 1], qy2,
                          m[..., 2, 1] + m[..., 1, 2]], -1)
    cand_z = torch.stack([m[..., 1, 0] - m[..., 0, 1],
                          m[..., 0, 2] + m[..., 2, 0],
                          m[..., 2, 1] + m[..., 1, 2], qz2], -1)
    mags = torch.stack([qw2, qx2, qy2, qz2], -1)
    best = torch.argmax(mags, dim=-1)            # first maximum, as jnp
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], -2)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    pivot = torch.gather(mags, -1, best[..., None])
    q = q / (2.0 * torch.sqrt(pivot.clamp_min(_EPS))).clamp_min(_EPS)
    q = torch.where(q[..., :1] < 0, -q, q)
    return q / _norm(q).clamp_min(_EPS)


def quaternion_to_axis_angle(quat: torch.Tensor) -> torch.Tensor:
    quat = quat / _norm(quat).clamp_min(_EPS)
    w = quat[..., :1]
    v = quat[..., 1:]
    vn = _norm(v)
    angle = 2.0 * torch.atan2(vn, w)
    small = vn < 1e-6
    safe_vn = torch.where(small, torch.ones_like(vn), vn)
    taylor = 2.0 / w.abs().clamp_min(_EPS) * torch.sign(w + (w == 0).to(w.dtype))
    scale = torch.where(small, taylor, angle / safe_vn)
    return v * scale


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) via Gram-Schmidt (first two ROWS)."""
    a1 = d6[..., 0:3]
    a2 = d6[..., 3:6]
    b1 = a1 / _norm(a1).clamp_min(_EPS)
    a2p = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2p / _norm(a2p).clamp_min(_EPS)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], -2)


def rotation_6d_to_axis_angle(d6: torch.Tensor) -> torch.Tensor:
    return matrix_to_axis_angle(rotation_6d_to_matrix(d6))
