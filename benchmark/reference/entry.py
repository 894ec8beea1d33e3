"""The reference's entries, stage by stage, at the cell's own sizes.

`build` makes the plain model of a configuration (compute dtype float32)
on the current default device. A served request is a chain (the audio
rollout, the SMPL-X decoder, the renderer, the splat) fed by the program's
own token window, so each stage here starts from what the program handed
the next stage, and is held to what the program made of it:

- `serve_stages`: the next token windows from the program's input window,
  the decoded parameters from the program's output tokens, the gaussians
  from the program's output tokens and parameters, the frames from the
  program's gaussians;
- `recon_stages`: the fused tokens from the request's inputs (the start),
  the decoded parameters from the program's fused SMPL-X tokens, the
  gaussians from its fused triplane tokens, the reference and novel views
  from its gaussians, the entry's metrics from its outputs.

With `lowered`, each stage computes one step below the precision the
configuration states for it: the stacks it runs in bf16 in fp8 and the
decoder's fp32 matmuls in TF32 (the model inside `lower_precision`), the
fp32 splat and metrics on bf16 inputs. That is the control. All else runs in fp32 with TF32 off.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
from torch import nn

from .plain_avatar.device import fp32_geometry
from .plain_avatar.models import upsampler
from .plain_avatar.models.audio_avatar import AudioDrivenAvatar
from .plain_avatar.models.avatar import TriplaneGaussianAvatar
from .plain_avatar.models.config import AvatarConfig, check_supported
from .plain_avatar.models.renderer import build_renderer_statics
from .plain_avatar.models.triplane_encoder import reshape_params
from .plain_avatar.ops import smplx, splat_tiles
from .plain_avatar.ops.splat_segmented import render_frames_segmented
from .plain_avatar.training.stage1 import render_novel, stage1_metrics
from .plain_avatar.utils.losses import psnr

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0
GAUSSIAN_KEYS = ("xyz", "rot", "scale", "opacity", "color")


def avatar_config(fields: dict) -> AvatarConfig:
    """A configuration file's `model` fields as the reference runs them:
    lists as tuples, compute dtype float32; a form the reference does not
    compute raises."""
    over = {k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()}
    over["compute_dtype"] = "float32"
    return check_supported(dataclasses.replace(AvatarConfig(), **over))


def body(seed: int, num_verts: int = smplx.SMPLX_NUM_VERTS) -> smplx.SmplxModel:
    """The synthetic SMPL-X body (10,475 vertices unless a smaller one is
    asked for) drawn from `seed` (numpy)."""
    return smplx.synthetic_model(seed=seed % 2 ** 32, num_verts=num_verts)


def num_verts_encoder(model: smplx.SmplxModel) -> int:
    return int(np.asarray(model.v_template).shape[0]) + int(np.asarray(model.faces).shape[0])


def build(kind: str, cfg: AvatarConfig, smplx_model: smplx.SmplxModel) -> nn.Module:
    """'serve': the stage-2 serving model; 'recon': the stage-1 model."""
    if kind == "serve":
        model = AudioDrivenAvatar(cfg)
    elif kind == "recon":
        model = TriplaneGaussianAvatar(cfg, num_verts_encoder(smplx_model))
    else:
        raise ValueError(f"unknown reference kind {kind!r}")
    return model.eval().requires_grad_(False)


def statics(cfg: AvatarConfig, smplx_model: smplx.SmplxModel, device):
    return build_renderer_statics(smplx_model, device, subdivide_steps=cfg.subdivide_steps,
                                  densify=cfg.densify_smplx_verts)


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def gaussians_of(gaussians: dict, lowered: bool) -> dict:
    """The five gaussian fields in fp32 (rounded to bf16 for the control)."""
    return {k: bf16_round(gaussians[k].float()) if lowered else gaussians[k].float()
            for k in GAUSSIAN_KEYS}


def decode(model, tokens: torch.Tensor) -> dict:
    """SMPL-X parameters (B, T, ...) of tokens (B, T, C, L)."""
    B, T = tokens.shape[:2]
    return reshape_params(model.smpl_decoder(tokens.float().reshape((B * T,) + tokens.shape[2:])),
                          (B, T))


def splat_serving(cfg, gaussians: dict, cams: dict, lowered: bool) -> torch.Tensor:
    """Frames (B, T, H, W, 3) of the program's gaussians (B*T, N, ...), by
    the segmented splat, frames_per_chunk frames at a time."""
    g = gaussians_of(gaussians, lowered)
    B, T = cams["intrinsic"].shape[:2]
    K, E = cams["intrinsic"].reshape(B * T, 3, 3), cams["extrinsic"].reshape(B * T, 4, 4)
    H, W = cfg.image_size
    F = cfg.frames_per_chunk if cfg.frames_per_chunk > 0 and (B * T) % cfg.frames_per_chunk == 0 else 1
    frames = [render_frames_segmented(
        g["xyz"][c:c + F], g["rot"][c:c + F], g["scale"][c:c + F], g["opacity"][c:c + F, :, 0],
        g["color"][c:c + F], K[c:c + F], E[c:c + F], W, H, max_per_tile=cfg.max_per_tile,
        max_window=cfg.splat_max_window, large_cap=cfg.splat_large_cap)
        for c in range(0, B * T, F)]
    return torch.cat(frames).reshape((B, T) + frames[0].shape[1:])


def splat_reference(cfg, gaussians: dict, cams: dict, lowered: bool) -> torch.Tensor:
    """Reference views (B, T, H, W, 3) of the program's gaussians, by the
    tile splat, frames_per_chunk frames at a time."""
    g = gaussians_of(gaussians, lowered)
    B, T = cams["intrinsic"].shape[:2]
    K, E = cams["intrinsic"].reshape(B * T, 3, 3), cams["extrinsic"].reshape(B * T, 4, 4)
    H, W = cfg.image_size
    F = cfg.frames_per_chunk if cfg.frames_per_chunk > 0 and (B * T) % cfg.frames_per_chunk == 0 else 1
    frames = [splat_tiles.render_frames(
        g["xyz"][c:c + F], g["rot"][c:c + F], g["scale"][c:c + F], g["opacity"][c:c + F, :, 0],
        g["color"][c:c + F], K[c:c + F], E[c:c + F], W, H, max_per_tile=cfg.max_per_tile,
        max_window=cfg.splat_max_window) for c in range(0, B * T, F)]
    return torch.cat(frames).reshape((B, T) + frames[0].shape[1:])


@torch.no_grad()
def serve_stages(model, stat, got: dict, lowered: bool = False) -> dict:
    """One served request, stage by stage from the program's own state
    (`got`: its inputs, its full output tokens, parameters and gaussians)."""
    tri, smpl, audio, cams = got["inputs"]
    cfg = model.cfg
    with fp32_geometry():
        out_tri, out_smpl = model.audio_triplane(audio.float(), tri.float(), smpl.float())
        T_in = tri.shape[1]
        pred = decode(model, got["out_smpl"])
        _, gaussians = model.renderer(stat, got["out_tri"].float(), cams, got["pred"])
        frames = splat_serving(cfg, got["gaussians"], cams, lowered)
    return {"tri": out_tri[:, -T_in:], "smpl": out_smpl[:, -T_in:], "pred": pred,
            "gaussians": {k: gaussians[k] for k in GAUSSIAN_KEYS}, "frames": frames}


@torch.no_grad()
def recon_stages(model, stat, got: dict, lowered: bool = False) -> dict:
    """One reconstruction request, stage by stage: the fused tokens from the
    inputs, the rest from the program's own outputs (`got`)."""
    ref, test = got["inputs"]
    cfg = model.cfg
    with fp32_geometry():
        fused = model(stat, ref.video, ref.smpl_parms, ref.cam_parms, render=False)
        pred = decode(model, got["smpl"])
        _, gaussians = model.renderer(stat, got["tri"].float(), ref.cam_parms, ref.smpl_parms)
        reference = splat_reference(cfg, got["gaussians"], ref.cam_parms, lowered)
        novel = render_novel(gaussians_of(got["gaussians"], lowered), test, cfg)
        frames, views = got["reference"].float(), got["novel"].float()
        if lowered:
            frames, views = bf16_round(frames), bf16_round(views)
        metrics = stage1_metrics(frames, views, gaussians_of(got["gaussians"], lowered),
                                 got["pred_1"], got["pred_2"], ref, test)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["psnr_train"] = float(psnr(frames, ref.video.permute(0, 1, 3, 4, 2)))
        metrics["psnr_test"] = float(psnr(views, test.video.permute(0, 1, 3, 4, 2)))
    return {"tri": fused.triplane_tokens, "smpl": fused.smpl_tokens, "pred": pred,
            "gaussians": {k: gaussians[k] for k in GAUSSIAN_KEYS},
            "reference": reference, "novel": novel, "metrics": metrics}


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """fp32 t rounded to TF32's 10-bit mantissa (to nearest, ties away),
    as the tensor cores take a TF32 operand."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).to(t.dtype)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to e4m3 under one scale that maps its largest magnitude to
    e4m3's largest, returned in t's dtype."""
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return ((t.float() * scale).to(FP8).float() / scale).to(t.dtype)


@contextlib.contextmanager
def lower_precision(model: nn.Module, bf16_modules, fp32_modules):
    """Inside the block, `model` is the control's: in the submodules named
    by `bf16_modules` (the stacks the configuration runs in bf16) every
    weight of two or more dimensions, every Linear's input and every
    operand of the upsampler's convolutions rounded to fp8; in those named
    by `fp32_modules` (fp32 matmuls with TF32 off) weights and Linear
    inputs rounded to TF32. The weights stay rounded after it."""
    hooks = []
    with torch.no_grad():
        for prefixes, rnd in ((bf16_modules, fp8_round), (fp32_modules, tf32_round)):
            def round_input(module, args, rnd=rnd):
                return (rnd(args[0]),) + tuple(args[1:])

            for name, module in model.named_modules():
                if not any(name == p or name.startswith(p + ".") for p in prefixes):
                    continue
                for p in module.parameters(recurse=False):
                    if p.dim() >= 2:
                        p.copy_(rnd(p))
                if isinstance(module, nn.Linear):
                    hooks.append(module.register_forward_pre_hook(round_input))
    upsampler.OPERAND_ROUND = fp8_round
    try:
        yield model
    finally:
        upsampler.OPERAND_ROUND = None
        for h in hooks:
            h.remove()
