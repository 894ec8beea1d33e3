"""Audio-driven triplane / SMPL-X token rollout network (stage 2).

TriplaneTemporalReducer: depthwise temporal conv over the T input frames;
SMPLXTemporalReducer: per-token-position temporal self-attention + MLP,
mean-pooled over time; AudioTriplaneNet: query = [triplane-motion |
smplx-motion | last-triplane | last-smplx], then an autoregressive rollout
over T_out steps, each cross-attending to that step's audio feature.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .transformer import LayerNorm, Transformer1D, merge_heads, split_heads


class TriplaneTemporalReducer(nn.Module):
    """(B, T, C, S=3R^2) -> (B, C, S). The weight has the reference
    Conv3d(3C, 3C, (T, 1, 1), groups=3C) layout (3C, 1, T, 1, 1), channel
    index plane * C + c; tokens are plane-major along S."""

    def __init__(self, channels: int, time_steps: int):
        super().__init__()
        self.channels, self.time_steps = channels, time_steps
        self.weight = nn.Parameter(torch.empty(3 * channels, 1, time_steps, 1, 1))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        B, T, C, S = tokens.shape
        w = self.weight.reshape(3, C, T)
        x = tokens.reshape(B, T, C, 3, S // 3)
        return torch.einsum("btcps,pct->bcps", x, w).reshape(B, C, S)


class _MultiHeadAttention(nn.Module):
    """flax MultiHeadDotProductAttention (biased q/k/v/out, fp32)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = split_heads(self.query(x), self.heads)
        k = split_heads(self.key(x), self.heads)
        v = split_heads(self.value(x), self.heads)
        logits = torch.einsum("bhqd,bhkd->bhqk", q / q.shape[-1] ** 0.5, k)
        out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, -1), v)
        return self.out(merge_heads(out))


class SMPLXTemporalReducer(nn.Module):
    """(B, T, C, L) -> (B, C, L): temporal self-attention per token position,
    post-LN residuals, mean over time."""

    def __init__(self, channels: int, time_steps: int, heads: int = 8):
        super().__init__()
        self.self_attn = _MultiHeadAttention(channels, heads)
        self.norm1 = LayerNorm(channels)
        self.mlp1 = nn.Linear(channels, 2 * channels)
        self.mlp2 = nn.Linear(2 * channels, channels)
        self.norm2 = LayerNorm(channels)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        B, T, C, L = tokens.shape
        x = tokens.permute(0, 3, 1, 2).reshape(B * L, T, C)
        x = self.norm1(x + self.self_attn(x))
        h = self.mlp2(torch.relu(self.mlp1(x)))
        x = self.norm2(x + h).mean(dim=1)
        return x.reshape(B, L, C).transpose(1, 2)


class AudioTriplaneNet(nn.Module):
    """forward(audio (B, T_a, C_a), triplane tokens (B, T_in, C, S_tri),
    smpl tokens (B, T_in, C, L)) -> (out_tri (B, T_out, C, S_tri),
    out_smpl (B, T_out, C, L))."""

    def __init__(self, feature_dim: int = 256, triplane_resolution: int = 32,
                 smpl_token_len: int = 80, input_frames: int = 2,
                 output_frames: int = 6, layers: int = 8, head_dim: int = 64,
                 heads: int = 8, audio_feature_dim: int = 768,
                 compute_dtype: Optional[torch.dtype] = None,
                 gelu_approx: bool = False):
        super().__init__()
        self.S_tri = 3 * triplane_resolution ** 2
        self.L = smpl_token_len
        self.output_frames = output_frames
        self.triplane_motion_encoder = TriplaneTemporalReducer(
            feature_dim, input_frames)
        self.smplx_motion_encoder = SMPLXTemporalReducer(feature_dim,
                                                         input_frames)
        # every AR step keeps only the trailing [new_tri | new_smpl] tokens:
        # the last block computes just those queries (exact)
        self.transformer = Transformer1D(
            layers, heads, head_dim, feature_dim,
            context_dim=audio_feature_dim, dtype=compute_dtype,
            final_tail=self.S_tri + self.L, gelu_approx=gelu_approx)

    def forward(self, audio_features: torch.Tensor,
                triplane_tokens: torch.Tensor, smpl_tokens: torch.Tensor):
        S_tri, L = self.S_tri, self.L
        if triplane_tokens.shape[-1] != S_tri:
            raise ValueError(f"triplane tokens {tuple(triplane_tokens.shape)} "
                             f"do not have S={S_tri}")
        tri_motion = self.triplane_motion_encoder(triplane_tokens)
        smpl_motion = self.smplx_motion_encoder(smpl_tokens)
        last_tri, last_smpl = triplane_tokens[:, -1], smpl_tokens[:, -1]
        outs_tri, outs_smpl = [], []
        for t in range(self.output_frames):
            query = torch.cat([tri_motion, smpl_motion, last_tri, last_smpl], -1)
            out = self.transformer(query, audio_features[:, t:t + 1])
            new_smpl = out[:, :, -L:]
            new_tri = out[:, :, :S_tri]
            # (new, last) pair order of the reference re-encoders
            tri_motion = self.triplane_motion_encoder(
                torch.stack([new_tri, last_tri], 1))
            smpl_motion = self.smplx_motion_encoder(
                torch.stack([last_smpl, new_smpl], 1))
            last_tri, last_smpl = new_tri, new_smpl
            outs_tri.append(new_tri)
            outs_smpl.append(new_smpl)
        return torch.stack(outs_tri, 1), torch.stack(outs_smpl, 1)
