"""SMPL-X-anchored triplane encoder (the stage-1 geometry backbone).

1. SMPL-X predictor: learnable query tokens cross-attend to the image
   tokens (a Transformer1D: self-attention over L queries, cross-attention
   to the S image tokens, both through kernel A with 64-wide heads),
   decoded by the SMPL-X decoder;
2. SMPL-X forward + face-centre densification;
3. a learned per-vertex embedding, concatenated with the z-buffered image
   features at the projected vertices;
4. ConvONet-style local pooling: ResnetBlockFC blocks with per-cell max
   pooling between them, then mean-scattered planes at R.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import smplx as smplx_ops
from ..ops import subdivision, triplane
from ..ops.point_raster import lift_image_features
from .smplx_decoder import SMPLXDecoder
from .transformer import Transformer1D


def reshape_params(params: dict, lead: tuple) -> dict:
    """(BT, ...) param dict -> (B, T, ...)."""
    return {k: v.reshape(tuple(lead) + tuple(v.shape[1:]))
            for k, v in params.items()}


def flatten_params(params: dict) -> dict:
    """(B, T, ...) -> (B*T, ...)."""
    return {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in params.items()}


class ResnetBlockFC(nn.Module):
    """Pre-activation FC ResNet block (shortcut projection when the width
    changes)."""

    def __init__(self, size_in: int, size_out: int):
        super().__init__()
        size_h = min(size_in, size_out)
        self.fc_0 = nn.Linear(size_in, size_h)
        self.fc_1 = nn.Linear(size_h, size_out)
        self.shortcut = (None if size_in == size_out
                         else nn.Linear(size_in, size_out, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dx = self.fc_1(torch.relu(self.fc_0(torch.relu(x))))
        xs = x if self.shortcut is None else self.shortcut(x)
        return xs + dx


class SMPLXTriplaneEncoder(nn.Module):
    def __init__(self, num_verts: int, triplane_resolution: int = 32,
                 feature_dim: int = 256, radius: float = 1.4,
                 smpl_token_len: int = 80, smpl_token_dim: int = 256,
                 smplx_transformer_layers: int = 4,
                 smplx_transformer_head_dim: int = 64,
                 smplx_transformer_num_heads: int = 8,
                 image_feature_dim: int = 1536, sample_feature: bool = True,
                 predict_smplx_params: bool = True,
                 num_expression_coeffs: int = 10,
                 flat_hand_mean: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_verts, self.resolution, self.radius = num_verts, triplane_resolution, radius
        self.feature_dim, self.sample_feature = feature_dim, sample_feature
        self.flat_hand_mean = flat_hand_mean
        self.predict_smplx_params = predict_smplx_params
        if predict_smplx_params:
            self.smpl_tokens = nn.Parameter(torch.zeros(smpl_token_dim, smpl_token_len))
            self.smpl_cross_attn = Transformer1D(
                smplx_transformer_layers, smplx_transformer_num_heads,
                smplx_transformer_head_dim, smpl_token_dim,
                context_dim=image_feature_dim, dtype=compute_dtype)
            self.smpl_decoder = SMPLXDecoder(smpl_token_dim, smpl_token_len,
                                             num_expression_coeffs)
        emb_dim = feature_dim // 2 if sample_feature else feature_dim
        self.vertex_emb = nn.Embedding(num_verts, emb_dim)
        in_dim = 3 + emb_dim + (128 if sample_feature else 0)
        self.fc_pos = nn.Linear(in_dim, 2 * feature_dim)
        self.block_0 = ResnetBlockFC(2 * feature_dim, feature_dim)
        self.block_1 = ResnetBlockFC(2 * feature_dim, feature_dim)
        self.block_2 = ResnetBlockFC(2 * feature_dim, feature_dim)
        self.fc_c = nn.Linear(feature_dim, feature_dim)

    def smpl_predictor(self, image_tokens: torch.Tensor):
        """(BT, S, C_img) -> (params dict over BT, tokens (BT, C, L))."""
        BT = image_tokens.shape[0]
        q = self.smpl_tokens[None].expand((BT,) + self.smpl_tokens.shape)
        tokens = self.smpl_cross_attn(q, image_tokens)
        return self.smpl_decoder(tokens), tokens

    def forward(self, smplx_model: smplx_ops.SmplxModel,
                image_tokens: torch.Tensor, cam_params: Optional[dict] = None,
                smpl_params_gt: Optional[dict] = None,
                image_features: Optional[torch.Tensor] = None):
        """image_tokens (B, T, S, C_img), image_features (BT, 128, H, W) ->
        (planes (B, T, 3, C, R, R), smpl_tokens (B, T, C, L), predicted
        params (B, T, ...))."""
        B, T, S, C = image_tokens.shape
        BT = B * T
        pred_params = smpl_tokens = None
        if self.predict_smplx_params:
            pred_params, smpl_tokens = self.smpl_predictor(
                image_tokens.reshape(BT, S, C))
        params = smpl_params_gt if smpl_params_gt is not None else pred_params
        verts = smplx_ops.forward(smplx_model, params,
                                  flat_hand_mean=self.flat_hand_mean)
        verts = subdivision.face_center_densify(verts, smplx_model.faces)
        if verts.shape[-2] != self.num_verts:
            raise ValueError(f"{verts.shape[-2]} encoder vertices, the model "
                             f"was built for {self.num_verts}")
        feat = self.vertex_emb.weight[None].expand(BT, -1, -1)
        if self.sample_feature:
            transl = params["transl"].reshape(BT, 1, 3)
            sampled = lift_image_features(
                verts + transl, cam_params["extrinsic"].reshape(BT, 4, 4),
                cam_params["intrinsic"].reshape(BT, 3, 3), image_features)
            feat = torch.cat([feat, sampled], -1)
        net = self.block_0(self.fc_pos(torch.cat([verts, feat], -1)))
        R = self.resolution
        cell = triplane.plane_cell_index(verts, self.radius, R)    # (BT, 3, N)
        for block in (self.block_1, self.block_2):
            pooled = triplane.pool_local_max(net, cell, R)
            net = block(torch.cat([net, pooled], -1))
        c = self.fc_c(net)
        planes = torch.stack([triplane.scatter_mean_plane(c, cell[:, p], R)
                              for p in range(3)], 1)             # (BT, 3, C, R, R)
        planes = planes.reshape(B, T, 3, self.feature_dim, R, R)
        if smpl_tokens is not None:
            smpl_tokens = smpl_tokens.reshape((B, T) + smpl_tokens.shape[1:])
        if pred_params is not None:
            pred_params = reshape_params(pred_params, (B, T))
        return planes, smpl_tokens, pred_params
