"""Vertex -> image feature lifting with z-occlusion (the stage-1 encoder).

A two-pass z-buffer over flattened pixel ids: pass 1 keeps the least depth
of the points landing on each pixel (out-of-bounds points go to the extra
bucket H*W), pass 2 marks a point visible where its depth is within 1e-4 of
its pixel's; a visible point reads the feature map at its pixel, a hidden
or off-screen one reads 0. One pixel per point, as the JAX package's
point_raster (its stand-in for a one-point-per-pixel rasterizer).
"""

from __future__ import annotations

import torch

from ..device import fp32_geometry

BIG_DEPTH = 1e10


@fp32_geometry()
def project_to_pixels(points: torch.Tensor, extrinsic: torch.Tensor,
                      intrinsic: torch.Tensor):
    """points (B, N, 3) world, extrinsic (B, 4, 4), intrinsic (B, 3, 3) ->
    (u, v, depth) each (B, N), OpenCV convention."""
    cam = points @ extrinsic[:, :3, :3].transpose(1, 2) + extrinsic[:, None, :3, 3]
    z = cam[..., 2]
    z_safe = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    u = intrinsic[:, 0, 0, None] * cam[..., 0] / z_safe + intrinsic[:, 0, 2, None]
    v = intrinsic[:, 1, 1, None] * cam[..., 1] / z_safe + intrinsic[:, 1, 2, None]
    return u, v, z


def lift_image_features(points: torch.Tensor, extrinsic: torch.Tensor,
                        intrinsic: torch.Tensor, image_features: torch.Tensor,
                        z_eps: float = 1e-4) -> torch.Tensor:
    """points (B, N, 3), extrinsic (B, 4, 4), intrinsic (B, 3, 3),
    image_features (B, C, H, W) -> (B, N, C); hidden / off-screen -> 0."""
    B, C, H, W = image_features.shape
    u, v, z = project_to_pixels(points, extrinsic, intrinsic)
    px, py = torch.floor(u).long(), torch.floor(v).long()
    inb = (px >= 0) & (px < W) & (py >= 0) & (py < H) & (z > 0)
    pix = torch.where(inb, py * W + px, H * W)
    depth = torch.where(inb, z, torch.full_like(z, BIG_DEPTH))
    zbuf = depth.new_full((B, H * W + 1), BIG_DEPTH).scatter_reduce(
        1, pix, depth, "amin", include_self=False)
    visible = inb & (depth <= torch.gather(zbuf, 1, pix) + z_eps)
    idx = torch.clamp(pix, 0, H * W - 1)[:, None, :].expand(B, C, -1)
    sampled = torch.gather(image_features.reshape(B, C, H * W), 2, idx)
    return torch.where(visible[..., None], sampled.transpose(1, 2),
                       sampled.new_zeros(()))
