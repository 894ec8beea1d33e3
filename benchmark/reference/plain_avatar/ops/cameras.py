"""Camera math for the splatting pipeline (fp32 geometry).

Extrinsic E is a 4x4 world->camera (OpenCV, +z forward); intrinsic K is a
3x3 pixel matrix; the NDC projection is built from K with znear=0.01,
zfar=100. Batched over leading dims.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

ZNEAR = 0.01
ZFAR = 100.0


def focal2fov(focal: torch.Tensor, pixels: float) -> torch.Tensor:
    return 2.0 * torch.atan(pixels / (2.0 * focal))


def projection_ndc(K: torch.Tensor, width: float, height: float,
                   znear: float = ZNEAR, zfar: float = ZFAR) -> torch.Tensor:
    """(..., 3, 3) pixel intrinsics -> (..., 4, 4) camera->NDC."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    px, py = K[..., 0, 2], K[..., 1, 2]
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    z1 = torch.full_like(fx, zfar / (zfar - znear))
    z2 = torch.full_like(fx, -zfar * znear / (zfar - znear))
    rows = [torch.stack([2 * fx / width, zero, (2 * px - width) / width, zero], -1),
            torch.stack([zero, 2 * fy / height, (2 * py - height) / height, zero], -1),
            torch.stack([zero, zero, z1, z2], -1),
            torch.stack([zero, zero, one, zero], -1)]
    return torch.stack(rows, -2)


def camera_center(extrinsic: torch.Tensor) -> torch.Tensor:
    """-R^T t for E = [R | t]."""
    R = extrinsic[..., :3, :3]
    t = extrinsic[..., :3, 3]
    return -torch.einsum("...ij,...i->...j", R, t)


class Camera(NamedTuple):
    view: torch.Tensor       # (..., 4, 4) world->camera
    proj: torch.Tensor       # (..., 4, 4) camera->NDC
    center: torch.Tensor     # (..., 3)
    tan_fovx: torch.Tensor   # (...,)
    tan_fovy: torch.Tensor   # (...,)
    width: int
    height: int


def make_camera(K: torch.Tensor, E: torch.Tensor, width: int,
                height: int) -> Camera:
    fovx = focal2fov(K[..., 0, 0], float(width))
    fovy = focal2fov(K[..., 1, 1], float(height))
    return Camera(view=E, proj=projection_ndc(K, float(width), float(height)),
                  center=camera_center(E),
                  tan_fovx=torch.tan(fovx * 0.5), tan_fovy=torch.tan(fovy * 0.5),
                  width=width, height=height)


def orbit_camera(angle: float, dist: float = 2.5, height: float = 0.0,
                 focal: float = 600.0, image_size=(512, 512)):
    """OpenCV world->camera extrinsic orbiting the origin + intrinsics, as
    numpy (K (3, 3), E (4, 4)) float32 — the synthetic serving cameras."""
    H, W = image_size
    c, s = math.cos(angle), math.sin(angle)
    eye = np.array([dist * s, height, -dist * c], np.float64)
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    dn = np.cross(fwd, right)
    R = np.stack([right, dn, fwd], 0)
    E = np.eye(4, dtype=np.float32)
    E[:3, :3] = R
    E[:3, 3] = -R @ eye
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    return K, E
