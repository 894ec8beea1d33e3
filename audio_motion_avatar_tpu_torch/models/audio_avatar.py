"""Stage-2 composite: the audio-driven triplane avatar.

`triplane_gaussian` is the stage-1 model (models/avatar.py); its SMPL-X
decoder and renderer are shared with the audio rollout, as in the JAX
package (and named as in its flax tree). The stage-1 reconstruction turns
reference frames into the initial (triplane, SMPL-X) token state;
`AudioTriplaneNet` rolls the state forward per audio frame, the shared
decoder decodes every output frame's tokens and the shared renderer draws
the frames.

Built with `num_verts_encoder=None`, the model holds only what a rollout
from given tokens reads (no image encoder, triplane encoder body or fusion
network).

In the full forward (the training path) the stage-1 reconstruction runs
without autograd (the JAX package's stop_gradient on its tokens, the
reference's no_grad), and the prediction-cache curriculum may swap its
tokens for cached predictions: flag * cached + (1 - flag) * fresh.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..device import compute_dtype as _compute_dtype
from ..utils import profiling
from .audio_net import AudioTriplaneNet
from .avatar import TriplaneGaussianAvatar
from .config import AvatarConfig
from .renderer import Renderer, RendererStatics
from .smplx_decoder import SMPLXDecoder
from .triplane_encoder import reshape_params


class AudioAvatarOutput(NamedTuple):
    rendered_images: Optional[torch.Tensor]   # (B, T_out, H, W, 3)
    gaussians: dict
    pred_smplx_future: dict                   # (B, T_out, ...)
    output_triplane_tokens: torch.Tensor      # (B, T_out, C, S)
    output_smpl_tokens: torch.Tensor          # (B, T_out, C, L)
    ref_triplane_tokens: torch.Tensor         # (B, T_in, C, S)
    ref_smpl_tokens: torch.Tensor             # (B, T_in, C, L)
    ref_rendered: Optional[torch.Tensor]


class AudioDrivenAvatar(nn.Module):
    def __init__(self, cfg: AvatarConfig, num_verts_encoder: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        self.triplane_gaussian = TriplaneGaussianAvatar(
            cfg, num_verts_encoder or 0, stage1=num_verts_encoder is not None)
        self.audio_triplane = AudioTriplaneNet(
            feature_dim=cfg.triplane_feature_dim,
            triplane_resolution=cfg.triplane_resolution,
            smpl_token_len=cfg.smpl_token_len,
            input_frames=cfg.triplane_input_frames,
            output_frames=cfg.triplane_output_frames,
            layers=cfg.audio_transformer_layers,
            head_dim=cfg.audio_transformer_head_dim,
            heads=cfg.audio_transformer_num_heads,
            audio_feature_dim=cfg.audio_feature_dim,
            compute_dtype=_compute_dtype(cfg.compute_dtype),
            gelu_approx=cfg.gelu_approx, remat=cfg.audio_transformer_remat,
            attn_impl=cfg.audio_attn_impl)

    @property
    def smpl_decoder(self) -> SMPLXDecoder:
        return self.triplane_gaussian.smpl_decoder

    @property
    def renderer(self) -> Renderer:
        return self.triplane_gaussian.renderer

    def stage1_tokens(self, statics: RendererStatics, images: torch.Tensor,
                      smpl_params: Optional[dict], cams: dict):
        """Reference frames (B, T_in, 3, H, W) -> the initial (triplane
        tokens (B, T_in, C, S), SMPL-X tokens (B, T_in, C, L)): the stage-1
        forward with the render off."""
        out = self.triplane_gaussian(statics, images, smpl_params, cams,
                                     render=False)
        return out.triplane_tokens, out.smpl_tokens

    def _decode_and_render(self, statics, out_tri, out_smpl, cams):
        B, T = out_smpl.shape[:2]
        flat = out_smpl.reshape((B * T,) + out_smpl.shape[2:])
        with profiling.span("decode"):
            pred = reshape_params(self.smpl_decoder(flat), (B, T))
        rendered, gaussians = self.renderer(statics, out_tri, cams, pred)
        return rendered, pred, gaussians

    def rollout(self, statics: RendererStatics, triplanes: torch.Tensor,
                smpl_tokens: torch.Tensor, audio: torch.Tensor, cams: dict):
        """One chunk: tokens (B, T_in, C, S) / (B, T_in, C, L), audio
        (B, T_out, C_a), cameras (B, T_out, ...) -> (rendered (B, T_out, H,
        W, 3), out_tri, out_smpl, pred params (B, T_out, ...))."""
        out_tri, out_smpl = self.audio_triplane(audio, triplanes, smpl_tokens)
        rendered, pred, _ = self._decode_and_render(statics, out_tri, out_smpl, cams)
        return rendered, out_tri, out_smpl, pred

    def forward(self, statics: RendererStatics, ref_images: torch.Tensor,
                ref_smpl_params: Optional[dict], ref_cam_params: dict,
                audio_features: torch.Tensor, target_cam_params: dict,
                cached_triplanes: Optional[torch.Tensor] = None,
                cached_smpl_tokens: Optional[torch.Tensor] = None,
                use_cache: Optional[torch.Tensor] = None,
                render_ref: bool = False) -> AudioAvatarOutput:
        """The JAX package's AudioDrivenAvatar.__call__: stage-1
        reconstruction of the reference frames (no gradient), the cache
        swap where cached tokens are given (use_cache (B,) 0 / 1 flags), one
        audio rollout from the tokens, the targets rendered."""
        with torch.no_grad():
            out1 = self.triplane_gaussian(statics, ref_images, ref_smpl_params,
                                          ref_cam_params, render=render_ref)
        tri, smpl = out1.triplane_tokens, out1.smpl_tokens
        if cached_triplanes is not None:
            flag = use_cache.to(tri.dtype).reshape(-1, 1, 1, 1)
            tri = flag * cached_triplanes + (1 - flag) * tri
            smpl = flag * cached_smpl_tokens + (1 - flag) * smpl
        out_tri, out_smpl = self.audio_triplane(audio_features, tri, smpl)
        rendered, pred, gaussians = self._decode_and_render(
            statics, out_tri, out_smpl, target_cam_params)
        return AudioAvatarOutput(rendered, gaussians, pred, out_tri, out_smpl,
                                 tri, smpl, out1.rendered_images)
