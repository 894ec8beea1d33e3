"""TriplaneGaussianAvatar: the stage-1 reconstruction model.

Frozen Sapiens ViT -> per-pixel feature map -> SMPL-X-anchored triplane
encoder -> fusion transformer -> renderer. SMPL-X parameters are predicted
twice by ONE decoder (the encoder's `smpl_decoder`): pre-fusion inside the
encoder and post-fusion on the fused SMPL-X tokens.

Submodule names follow the JAX package's flax tree (sapiens_encoder,
image_feature, smplx_triplane_encoder, fusion_network, renderer), so that
`weights.params_from_flax` maps it leaf for leaf. The point refiner, which
the JAX package passes in from outside (its params sit at the tree's top
level), is the renderer's own submodule here.

`stage1=False` builds only what a serving rollout reads: the shared SMPL-X
decoder and the renderer, without the image encoder, the triplane encoder's
body and the fusion network.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..device import compute_dtype as _compute_dtype
from .fusion import FeatureFusionNetwork
from .image_encoder import ImageFeature, SapiensEncoder
from .ptv3 import build_point_refiner
from .renderer import Renderer, RendererStatics
from .smplx_decoder import SMPLXDecoder
from .triplane_encoder import SMPLXTriplaneEncoder, reshape_params


class AvatarOutput(NamedTuple):
    rendered_images: Optional[torch.Tensor]   # (B, T, H, W, 3)
    gaussians: dict                           # (B*T, N, ...)
    triplane_tokens: torch.Tensor             # (B, T, C, 3RR)
    image_tokens: torch.Tensor                # (B, T, S, C_img)
    pred_smpl_1: Optional[dict]               # pre-fusion prediction
    pred_smpl_2: Optional[dict]               # post-fusion prediction
    smpl_tokens: torch.Tensor                 # (B, T, C, L)


class _DecoderOnly(nn.Module):
    """The encoder's place in a serving-only model: its SMPL-X decoder, and
    the predictor's query tokens, which the JAX encoder's setup declares
    whenever the decoder is reached (unused here)."""

    def __init__(self, cfg):
        super().__init__()
        self.smpl_tokens = nn.Parameter(torch.zeros(cfg.smpl_token_dim, cfg.smpl_token_len))
        self.smpl_decoder = SMPLXDecoder(cfg.smpl_token_dim, cfg.smpl_token_len,
                                         cfg.num_expression_coeffs)


class TriplaneGaussianAvatar(nn.Module):
    def __init__(self, cfg, num_verts_encoder: int = 0, stage1: bool = True):
        super().__init__()
        self.cfg, self.stage1 = cfg, stage1
        dt = _compute_dtype(cfg.compute_dtype)
        if stage1:
            # the ViT computes in the compute dtype (fp32 in the reference)
            self.sapiens_encoder = SapiensEncoder(
                cfg.image_feature_dim, cfg.vit_depth, cfg.vit_heads,
                cfg.vit_patch, cfg.sapiens_resolution, compute_dtype=dt)
            self.image_feature = ImageFeature(cfg.image_feature_dim)
            self.smplx_triplane_encoder = SMPLXTriplaneEncoder(
                num_verts_encoder, cfg.triplane_resolution,
                cfg.triplane_feature_dim, cfg.radius, cfg.smpl_token_len,
                cfg.smpl_token_dim, cfg.smplx_transformer_layers,
                cfg.smplx_transformer_head_dim, cfg.smplx_transformer_num_heads,
                cfg.image_feature_dim, cfg.sample_feature,
                cfg.predict_smplx_params, cfg.num_expression_coeffs,
                cfg.flat_hand_mean, compute_dtype=dt)
            self.fusion_network = FeatureFusionNetwork(
                cfg.triplane_resolution, cfg.triplane_feature_dim,
                cfg.image_feature_dim, cfg.cross_transformer_layers,
                cfg.cross_transformer_head_dim, cfg.cross_transformer_num_heads,
                compute_dtype=dt)
        else:
            self.smplx_triplane_encoder = _DecoderOnly(cfg)
        refiner = None if cfg.no_point_refiner else build_point_refiner(cfg, dtype=dt)
        self.renderer = Renderer(cfg, point_refiner=refiner, compute_dtype=dt)

    @property
    def smpl_decoder(self) -> SMPLXDecoder:
        return self.smplx_triplane_encoder.smpl_decoder

    def forward(self, statics: RendererStatics, images: torch.Tensor,
                smpl_params_gt: Optional[dict], cam_params: dict,
                render: bool = True) -> AvatarOutput:
        """images (B, T, 3, H, W) in [0, 1]; cam_params intrinsic (B, T, 3,
        3), extrinsic (B, T, 4, 4); smpl_params_gt (B, T, ...) or None.
        render=False skips the renderer: no frames and no gaussians (the
        JAX package computes the gaussians and its jit drops them unused)."""
        if not self.stage1:
            raise RuntimeError("this model was built without the stage-1 "
                               "encoder stack (stage1=False)")
        B, T = images.shape[:2]
        tokens = self.sapiens_encoder(images.reshape((B * T,) + images.shape[2:]))
        image_tokens = tokens.reshape((B, T) + tokens.shape[1:])
        image_features = None
        if self.cfg.sample_feature:
            feats = self.image_feature(images, image_tokens)
            image_features = feats.reshape((B * T,) + feats.shape[2:])
        planes, smpl_tokens, pred_1 = self.smplx_triplane_encoder(
            statics.smplx_model, image_tokens, cam_params, smpl_params_gt,
            image_features)
        triplane_tokens, smpl_tokens = self.fusion_network(planes, image_tokens,
                                                           smpl_tokens)
        pred_2 = None
        if self.cfg.predict_smplx_params:
            flat = smpl_tokens.reshape((B * T,) + smpl_tokens.shape[2:])
            pred_2 = reshape_params(self.smpl_decoder(flat), (B, T))
        rendered, gaussians = None, {}
        if render:
            params = smpl_params_gt if smpl_params_gt is not None else pred_2
            rendered, gaussians = self.renderer(statics, triplane_tokens,
                                                cam_params, params)
        return AvatarOutput(rendered, gaussians, triplane_tokens, image_tokens,
                            pred_1, pred_2, smpl_tokens)
