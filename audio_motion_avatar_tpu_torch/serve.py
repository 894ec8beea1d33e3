"""Serving rollout: the port's entry point.

`build_rollout(cfg, device, dtype)` builds the stage-2 serving model and its
renderer statics; the returned `Rollout` maps (triplane tokens, SMPL-X
tokens, audio features, cameras) to (rendered frames, next triplane token
window, next SMPL-X token window, decoded params). Built with stage1=True it
also holds the stage-1 encoder stack, and `Rollout.tokens` turns reference
frames into the initial token window (the demo's stage-1 pass, render off).
`Rollout.chunks` runs several chunks in one call (main2's fused demo
groups). `serve` is the host loop that answers requests in order, sliding
the last-T_in token window from one chunk to the next, as the two-stream
demo does. Each call of a Rollout is one request of the port's tracer
(utils/profiling.py: `serve.request`).

Geometry (SMPL-X FK/LBS, projection, splatting) runs in fp32 with TF32 off;
the transformer, refiner and upsampler stacks run in cfg.compute_dtype
(bf16 on the card: kernels A, K9a and K9b take bf16 operands).

Over a mesh (`build_rollout(..., mesh=)`, parallel/mesh.py; the JAX
package's serving mesh of tests/test_serving_mesh.py) the B streams shard
over 'data' (each rank runs its rows; the answers are joined again, so the
caller sees the whole batch) and the annotated weights over 'model'.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from .device import resolve_device
from .models.audio_avatar import AudioDrivenAvatar
from .models.config import AvatarConfig
from .models.renderer import RendererStatics, build_renderer_statics
from .ops import smplx as smplx_ops
from .ops.attention import KERNEL_HEAD_DIM
from .ops.cameras import orbit_cameras
from .parallel import mesh as pmesh
from .utils import profiling
from .weights import init_weights


# the CLI override that sets the compute dtype from a YAML config (main2)
BF16_OVERRIDE = "model.compute_dtype=bfloat16"


class Rollout:
    """One serving chunk per call, on the model's device."""

    def __init__(self, model: AudioDrivenAvatar, statics: RendererStatics,
                 device: torch.device, mesh: Optional[pmesh.Mesh] = None):
        self.model, self.statics, self.device = model, statics, device
        self.mesh = mesh or pmesh.Mesh(1, 1)

    @torch.no_grad()
    def __call__(self, tri: torch.Tensor, smpl: torch.Tensor,
                 audio: torch.Tensor, cams: dict):
        """tri (B, T_in, C, S), smpl (B, T_in, C, L), audio (B, T_out, C_a),
        cams {intrinsic (B, T_out, 3, 3), extrinsic (B, T_out, 4, 4)} ->
        (rendered (B, T_out, H, W, 3), tri window, smpl window, pred)."""
        T_in = tri.shape[1]
        m = self.mesh
        with profiling.request("serve.request", self.device):
            rendered, out_tri, out_smpl, pred = self.model.rollout(
                self.statics, pmesh.rows(tri, m), pmesh.rows(smpl, m), pmesh.rows(audio, m),
                {k: pmesh.rows(v, m) for k, v in cams.items()})
            return (pmesh.gather_rows(rendered, m), pmesh.gather_rows(out_tri[:, -T_in:], m),
                    pmesh.gather_rows(out_smpl[:, -T_in:], m),
                    {k: pmesh.gather_rows(v, m) for k, v in pred.items()})

    @torch.no_grad()
    def chunks(self, tri: torch.Tensor, smpl: torch.Tensor, audio: torch.Tensor,
               cams: dict, n: int = 1):
        """n consecutive chunks in one call (the demo's fused group): audio
        (B, n T_out, C_a) and cameras (B, n T_out, ...) taken T_out frames
        a chunk, the token window slid after each -> (rendered (B, n T_out,
        H, W, 3), the last tri window, smpl window, pred (B, n T_out, ...)).
        Each chunk computes what one call of the rollout computes."""
        T_out = audio.shape[1] // n
        rendered, preds = [], []
        for c in range(n):
            sl = slice(c * T_out, (c + 1) * T_out)
            out = self(tri, smpl, audio[:, sl].contiguous(),
                       {k: v[:, sl].contiguous() for k, v in cams.items()})
            tri, smpl = out[1], out[2]
            rendered.append(out[0])
            preds.append(out[3])
        if n == 1:
            return rendered[0], tri, smpl, preds[0]
        return (torch.cat(rendered, 1), tri, smpl,
                {k: torch.cat([p[k] for p in preds], 1) for k in preds[0]})

    @torch.no_grad()
    def tokens(self, images: torch.Tensor, smpl_params: Optional[dict],
               cams: dict):
        """Reference frames (B, T_in, 3, H, W) in [0, 1], their SMPL-X
        params and cameras -> the initial (triplane, SMPL-X) token window."""
        m = self.mesh
        tri, smpl = self.model.stage1_tokens(
            self.statics, pmesh.rows(images, m),
            None if smpl_params is None else {k: pmesh.rows(v, m)
                                              for k, v in smpl_params.items()},
            {k: pmesh.rows(v, m) for k, v in cams.items()})
        return pmesh.gather_rows(tri, m), pmesh.gather_rows(smpl, m)


def check_kernel_dtype(cfg: AvatarConfig, device: torch.device,
                       stage1: bool) -> None:
    """Kernels A, K9a and K9b take bf16 operands: on the card, a
    configuration whose compute dtype is not bf16 may not have 64-wide heads
    in the stacks that run in it (the audio transformer, the PTv3 refiner
    and, with stage1, the SMPL-X predictor and the fusion transformer; the
    ViT runs in bf16 whatever the config says), nor Winograd upsampler convs
    at a width the kernels take (a multiple of 128)."""
    if device.type != "cuda" or cfg.compute_dtype == "bfloat16":
        return
    widths = [cfg.audio_transformer_head_dim] + [
        c // h for c, h in zip(cfg.ptv3_enc_channels + cfg.ptv3_dec_channels,
                               cfg.ptv3_enc_heads + cfg.ptv3_dec_heads)]
    if stage1:
        widths += [cfg.smplx_transformer_head_dim, cfg.cross_transformer_head_dim]
    if KERNEL_HEAD_DIM in widths:
        raise ValueError(
            f"head width {KERNEL_HEAD_DIM} runs through kernel A, which takes "
            f"bf16 operands: build with dtype=torch.bfloat16, or from a YAML "
            f"config pass the override {BF16_OVERRIDE} "
            f"(compute_dtype is {cfg.compute_dtype!r})")
    if cfg.upsampler_conv != "xla" and cfg.triplane_feature_dim % 128 == 0:
        raise ValueError(
            f"upsampler_conv={cfg.upsampler_conv!r} runs the Winograd kernels, which "
            f"take bf16 operands: build with dtype=torch.bfloat16, or from a "
            f"YAML config pass the override {BF16_OVERRIDE} "
            f"(compute_dtype is {cfg.compute_dtype!r})")


def with_dtype(cfg: AvatarConfig, dtype: Optional[torch.dtype]) -> AvatarConfig:
    """cfg with compute_dtype set from a torch dtype (None keeps it)."""
    if dtype is None:
        return cfg
    name = {torch.bfloat16: "bfloat16", torch.float32: "float32"}[dtype]
    return dataclasses.replace(cfg, compute_dtype=name)


def num_verts_encoder(smplx_model: smplx_ops.SmplxModel) -> int:
    """The stage-1 encoder's vertex count: the body's vertices plus its face
    centres."""
    return int(np.asarray(smplx_model.v_template).shape[0]) + \
        int(np.asarray(smplx_model.faces).shape[0])


def build_rollout(cfg: AvatarConfig, device=None,
                  dtype: Optional[torch.dtype] = None,
                  smplx_model: Optional[smplx_ops.SmplxModel] = None,
                  state_dict: Optional[dict] = None, seed: int = 0,
                  stage1: bool = False, mesh: Optional[pmesh.Mesh] = None) -> Rollout:
    """Serving model on `device` (CUDA unless "cpu" is asked for).

    dtype: compute dtype of the transformer / refiner / upsampler stacks
    (torch.bfloat16 on the card; None keeps cfg.compute_dtype). Weights come
    from `state_dict` (e.g. weights.params_from_flax) or a seeded init.
    smplx_model: numpy SMPL-X model (default: the synthetic stand-in).
    stage1: also build the stage-1 encoder stack (for `Rollout.tokens`).
    mesh: the process mesh (parallel/mesh.make_mesh): the weights, loaded
    whole, are then sharded over its 'model' axis and the streams over
    'data'.

    On the card, a configuration with head width 64 (kernel A's, which
    takes bf16 operands) needs the bf16 compute dtype; fp32 raises here
    (check_kernel_dtype). The geometry turns TF32 off for its own matmuls
    (device.fp32_geometry); no global setting is changed."""
    device = resolve_device(device)
    cfg = with_dtype(cfg, dtype)
    check_kernel_dtype(cfg, device, stage1)
    if smplx_model is None:
        smplx_model = smplx_ops.synthetic_model(seed=0)
    model = AudioDrivenAvatar(
        cfg, num_verts_encoder(smplx_model) if stage1 else None)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init_weights(model, seed)
    if mesh is not None:
        pmesh.shard_model(model, mesh)
    model.to(device).eval()
    statics = build_renderer_statics(smplx_model, device,
                                     subdivide_steps=cfg.subdivide_steps,
                                     densify=cfg.densify_smplx_verts)
    return Rollout(model, statics, device, mesh)


def serve(rollout: Rollout, tri: torch.Tensor, smpl: torch.Tensor,
          requests: Iterable[Tuple[torch.Tensor, dict]]) -> Iterator[tuple]:
    """Answer (audio, cams) requests in order; each answer is (rendered,
    pred). The token window slides from one request to the next."""
    for audio, cams in requests:
        rendered, tri, smpl, pred = rollout(tri, smpl, audio, cams)
        yield rendered, pred


def synthetic_inputs(cfg: AvatarConfig, batch: int, device, seed: int = 0):
    """Seeded initial token state, one chunk of audio features and orbiting
    cameras, as numpy-seeded tensors on `device`: (tri, smpl, audio, cams)."""
    rng = np.random.RandomState(seed)
    T_in, T_out = cfg.triplane_input_frames, cfg.triplane_output_frames
    C, L = cfg.triplane_feature_dim, cfg.smpl_token_len
    S_tri = 3 * cfg.triplane_resolution ** 2

    def t(a):
        return torch.as_tensor(a, device=device)

    tri = t(rng.randn(batch, T_in, C, S_tri).astype(np.float32) * 0.1)
    smpl = t(rng.randn(batch, T_in, C, L).astype(np.float32) * 0.1)
    audio = t(rng.randn(batch, T_out, cfg.audio_feature_dim).astype(np.float32) * 0.1)
    cams = {k: t(v) for k, v in orbit_cameras(batch, T_out, cfg.image_size).items()}
    return tri, smpl, audio, cams
