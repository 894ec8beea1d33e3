"""Stage-2 composite: the audio-driven triplane avatar, as served.

`triplane_gaussian` is the stage-1 model (models/avatar.py) built without
its encoders: it holds the SMPL-X decoder and the renderer, shared with the
audio rollout and named as in the JAX package's flax tree.
`AudioTriplaneNet` rolls the (triplane, SMPL-X) token state forward per
audio frame; the shared decoder decodes every output frame's tokens and the
shared renderer draws the frames (reference.entry.serve_stages runs them
stage by stage).
"""

from __future__ import annotations

from torch import nn

from ..device import compute_dtype as _compute_dtype
from .audio_net import AudioTriplaneNet
from .avatar import TriplaneGaussianAvatar
from .config import AvatarConfig
from .renderer import Renderer
from .smplx_decoder import SMPLXDecoder


class AudioDrivenAvatar(nn.Module):
    def __init__(self, cfg: AvatarConfig):
        super().__init__()
        self.cfg = cfg
        self.triplane_gaussian = TriplaneGaussianAvatar(cfg, 0, stage1=False)
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
            gelu_approx=cfg.gelu_approx)

    @property
    def smpl_decoder(self) -> SMPLXDecoder:
        return self.triplane_gaussian.smpl_decoder

    @property
    def renderer(self) -> Renderer:
        return self.triplane_gaussian.renderer
