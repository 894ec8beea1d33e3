"""Losses and image metrics (the JAX package's utils/losses.py), plain
PyTorch and differentiable as written: autograd of the geodesic loss's
clamped arccos and of SSIM matches jax.grad (tests/test_torch_grad_kernels.py).

L1 / L2, PSNR, windowed SSIM on (B, T, H, W, C) images (11x11 Gaussian
window, sigma 1.5, zero padding), the geodesic rotation loss and the
composite SMPL-X parameter loss with the same weights and priors.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..device import fp32_geometry
from ..ops.rotations import axis_angle_to_matrix


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return (pred - gt).abs().mean()


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return ((pred - gt) ** 2).mean()


def psnr(pred: torch.Tensor, gt: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    mse = ((pred - gt) ** 2).mean()
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


def gaussian_window(window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    g = torch.tensor([math.exp(-((x - window_size // 2) ** 2) / (2 * sigma ** 2))
                      for x in range(window_size)], dtype=torch.float32)
    g = g / g.sum()
    return torch.outer(g, g)


@fp32_geometry()
def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """SSIM index on (B, T, H, W, C) images: depthwise Gaussian filtering
    with zero padding, averaged over everything (fp32 convolutions, TF32
    off)."""
    x = img1.reshape((-1,) + img1.shape[2:]).permute(0, 3, 1, 2)   # (BT, C, H, W)
    y = img2.reshape((-1,) + img2.shape[2:]).permute(0, 3, 1, 2)
    C = x.shape[1]
    w = gaussian_window(window_size).to(x.device, x.dtype)
    kernel = w[None, None].expand(C, 1, window_size, window_size)

    def blur(im):
        return F.conv2d(im, kernel, padding=window_size // 2, groups=C)

    mu1, mu2 = blur(x), blur(y)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = blur(x * x) - mu1_sq
    s2 = blur(y * y) - mu2_sq
    s12 = blur(x * y) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / \
        ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return ssim_map.mean()


def rotation_geodesic_loss(pred_aa: torch.Tensor, gt_aa: torch.Tensor) -> torch.Tensor:
    """Mean geodesic angle between axis-angle rotation sets (cos clamped to
    +-0.999)."""
    Rp = axis_angle_to_matrix(pred_aa.reshape(-1, 3))
    Rg = axis_angle_to_matrix(gt_aa.reshape(-1, 3))
    RT = torch.einsum("nij,nik->njk", Rp, Rg)
    cos = (RT.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    return torch.arccos(torch.clamp(cos, -0.999, 0.999)).mean()


def smooth_l1(pred: torch.Tensor, gt: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    d = (pred - gt).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).mean()


_ROT_KEYS = ("global_orient", "body_pose", "left_hand_pose", "right_hand_pose",
             "jaw_pose", "leye_pose", "reye_pose")


def smplx_param_loss(pred_params: dict, gt_params: dict,
                     weights: Optional[dict] = None):
    """MSE betas (+0.01 prior), geodesic poses, L1 expression (+0.01
    prior), smooth-L1 transl. Returns (total, per-key dict)."""
    weights = weights or {}
    losses = {}
    total = 0.0
    if "betas" in pred_params and "betas" in gt_params:
        pb = pred_params["betas"]
        l_shape = l2_loss(pb, gt_params["betas"].reshape(pb.shape))
        prior = (pb ** 2).mean()
        losses.update(betas_mse=l_shape, betas_prior=prior)
        total = total + weights.get("betas", 1.0) * l_shape + 0.01 * prior
    for key in _ROT_KEYS:
        if key in pred_params and key in gt_params:
            l_geo = rotation_geodesic_loss(pred_params[key], gt_params[key])
            losses[f"{key}_geo"] = l_geo
            total = total + weights.get(key, 1.0) * l_geo
    if "expression" in pred_params and "expression" in gt_params:
        pe = pred_params["expression"]
        l_expr = l1_loss(pe, gt_params["expression"].reshape(pe.shape))
        prior = (pe ** 2).mean()
        losses.update(expression_l1=l_expr, expression_prior=prior)
        total = total + weights.get("expression", 1.0) * l_expr + 0.01 * prior
    if "transl" in pred_params and "transl" in gt_params:
        pt = pred_params["transl"]
        l_t = smooth_l1(pt, gt_params["transl"].reshape(pt.shape))
        losses["transl_smoothl1"] = l_t
        total = total + weights.get("transl", 1.0) * l_t
    return total, losses
