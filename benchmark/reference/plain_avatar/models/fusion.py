"""Feature fusion: positional-embedded triplane tokens (3 R^2) and SMPL-X
tokens (L) concatenated on the sequence axis, an N-layer self + cross
transformer attending to the image tokens, split back. With 64-wide heads
both attentions run through kernel A (3 R^2 + L queries; 3232 at full
width, cross-attending to 4096 image tokens)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .tokenizers import TriplanePositionalEmbedding
from .transformer import Transformer1D


class FeatureFusionNetwork(nn.Module):
    def __init__(self, triplane_resolution: int = 32, feature_dim: int = 256,
                 image_feature_dim: int = 1536, layers: int = 8,
                 head_dim: int = 64, heads: int = 8,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.triplane_tokenizer = TriplanePositionalEmbedding(
            feature_dim, triplane_resolution)
        self.transformer_cross = Transformer1D(
            layers, heads, head_dim, feature_dim,
            context_dim=image_feature_dim, dtype=compute_dtype)

    def forward(self, geometry_planes: torch.Tensor, image_tokens: torch.Tensor,
                smpl_tokens: torch.Tensor):
        """planes (B, T, 3, C, R, R), image tokens (B, T, S, C_img), SMPL-X
        tokens (B, T, C, L) -> (triplane tokens (B, T, C, 3RR), SMPL-X
        tokens (B, T, C, L))."""
        B, T = geometry_planes.shape[:2]
        BT = B * T
        planes = geometry_planes.reshape((BT,) + geometry_planes.shape[2:])
        img = image_tokens.reshape((BT,) + image_tokens.shape[2:])
        smpl = smpl_tokens.reshape((BT,) + smpl_tokens.shape[2:])
        tokens = self.triplane_tokenizer(BT, planes)
        out = self.transformer_cross(torch.cat([tokens, smpl], 2), img)
        n_tri = tokens.shape[2]
        tri_out, smpl_out = out[:, :, :n_tri], out[:, :, n_tri:]
        return (tri_out.reshape((B, T) + tri_out.shape[1:]),
                smpl_out.reshape((B, T) + smpl_out.shape[1:]))
