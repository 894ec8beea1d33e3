"""Image encoder stack: the Sapiens-style frozen ViT and the per-pixel
feature pyramid (ImageFeature) of the stage-1 model.

The ViT follows torch autocast semantics as the JAX package's does: patch
embedding, attention and MLP matmuls in the compute dtype (bf16 by default,
whatever the model config says), LayerNorms in fp32 with flax's eps 1e-6,
exact erf GELU, the residual stream in the compute dtype and the output
cast to fp32. Its attention is the PTv3 patch attention with biases; with
64-wide heads (Sapiens-1B: 1536 / 24) it runs through kernel A.

`resize_bilinear` reproduces jax.image.resize(method='bilinear') exactly:
separable weight matrices of the triangle kernel, widened by the scale when
downsampling (antialias), normalised per output sample and zeroed for
samples outside the input; a dimension whose size does not change is left
as it is.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .ptv3 import _PatchAttention
from .transformer import LayerNorm, linear

SAPIENS_MEAN = (0.4844, 0.4570, 0.4062)
SAPIENS_STD = (0.2295, 0.2236, 0.2256)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of jax.image.resize's bilinear
    rule along one axis (scale out/in, no translation, antialias on)."""
    f32 = np.float32
    inv = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(0, keepdims=True, dtype=f32)
    ok = np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps)
    w = np.where(ok, w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(x: torch.Tensor, size: Sequence[int],
                    dims: Sequence[int]) -> torch.Tensor:
    """Resize axes `dims` of x to `size` by jax.image.resize's bilinear
    rule (see resize_weights)."""
    for d, n in zip(dims, size):
        m = x.shape[d]
        if m == n:
            continue
        w = torch.as_tensor(resize_weights(m, n), dtype=x.dtype, device=x.device)
        x = torch.tensordot(x.movedim(d, -1), w, dims=1).movedim(-1, d)
    return x


def preprocess(images: torch.Tensor, resolution: int) -> torch.Tensor:
    """(B, 3, H, W) in [0, 1] -> padded to square with 1, resized to
    resolution^2, Sapiens-normalised."""
    B, C, H, W = images.shape
    m = max(H, W)
    ph, pw = m - H, m - W
    images = F.pad(images, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2),
                   value=1.0)
    images = resize_bilinear(images, (resolution, resolution), (2, 3))
    mean = torch.tensor(SAPIENS_MEAN, device=images.device).reshape(1, 3, 1, 1)
    std = torch.tensor(SAPIENS_STD, device=images.device).reshape(1, 3, 1, 1)
    return (images - mean) / std


class ViTBlock(nn.Module):
    """Pre-LN block: fp32 LayerNorm -> patch attention -> residual; fp32
    LayerNorm -> MLP with exact GELU -> residual."""

    def __init__(self, width: int, heads: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.ln1 = LayerNorm(width)
        self.attn = _PatchAttention(width, heads, dtype)
        self.ln2 = LayerNorm(width)
        self.mlp1 = nn.Linear(width, 4 * width)
        self.mlp2 = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        h = F.gelu(linear(self.ln2(x), self.mlp1, self.dtype))
        return x + linear(h, self.mlp2, self.dtype)


class VisionTransformer(nn.Module):
    """Patch embedding + learned position embedding + blocks + final
    LayerNorm: (B, 3, H, W) -> (B, (H/p)(W/p), width), fp32 out."""

    def __init__(self, width: int = 1536, depth: int = 40, heads: int = 24,
                 patch: int = 16, resolution: int = 1024,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.patch, self.dtype, self.depth = patch, dtype, depth
        self.patch_embed = nn.Conv2d(3, width, patch, stride=patch)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, (resolution // patch) ** 2, width))
        for i in range(depth):
            self.add_module(f"block_{i}", ViTBlock(width, heads, dtype))
        self.ln_final = LayerNorm(width)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        w = self.patch_embed.weight if dt is None else self.patch_embed.weight.to(dt)
        b = self.patch_embed.bias if dt is None else self.patch_embed.bias.to(dt)
        x = F.conv2d(images if dt is None else images.to(dt), w, b,
                     stride=self.patch)
        x = x.flatten(2).transpose(1, 2)                        # (B, S, width)
        x = x + self.pos_embed[:, :x.shape[1]].to(x.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
        return self.ln_final(x)


class SapiensEncoder(nn.Module):
    """Frozen patch-token encoder: (B, 3, H, W) in [0, 1] -> (B, S, width)
    fp32. compute_dtype defaults to bf16, as the reference's autocast. The
    ViT runs without autograd and its tokens carry no gradient (the JAX
    package's stop_gradient): training never reaches its parameters."""

    def __init__(self, width: int = 1536, depth: int = 40, heads: int = 24,
                 patch: int = 16, resolution: int = 1024,
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16):
        super().__init__()
        self.resolution = resolution
        self.vit = VisionTransformer(width, depth, heads, patch, resolution,
                                     dtype=compute_dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.vit(preprocess(images, self.resolution)).float()


class ImageFeature(nn.Module):
    """Per-pixel features: tokens -> Linear(width -> out - 3) -> g x g map
    -> bilinear to H x W -> concat RGB. rgb (B, T, 3, H, W), tokens (B, T,
    S, C) -> (B, T, out_dim, H, W)."""

    def __init__(self, token_dim: int = 1536, out_dim: int = 128):
        super().__init__()
        self.out_dim = out_dim
        self.feature_reducer = nn.Linear(token_dim, out_dim - 3)

    def forward(self, rgb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        B, T, _, H, W = rgb.shape
        g = int(round(tokens.shape[2] ** 0.5))
        feat = self.feature_reducer(tokens).reshape(B * T, g, g, self.out_dim - 3)
        feat = resize_bilinear(feat, (H, W), (1, 2)).permute(0, 3, 1, 2)
        out = torch.cat([rgb.reshape(B * T, 3, H, W), feat], 1)
        return out.reshape(B, T, self.out_dim, H, W)
