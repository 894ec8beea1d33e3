"""Config tree -> static model / optimizer configs (the JAX package's
configs/build.py).

The port's AvatarConfig leaves out the JAX package's execution knobs whose
every value computes the same function in the port (models/config.py): a
YAML or CLI value for one of them (IGNORED_KNOBS) is accepted and dropped.
Every other knob is a field and is read.
"""

from __future__ import annotations

import dataclasses
import os

from ..models.config import AvatarConfig, SERVING_PROFILE, SERVING_PROFILE_MODEL
from ..training.train_state import OptimConfig
from .loader import Config

# JAX execution knobs whose every value computes the same function here:
# the frame scan's unroll factor, the quad-row builder ('xla' | 'pallas':
# kernel Q is that function) and the splat composite's implementation
# ('pallas' | 'tiles' | 'naive': the tile composite, K1 on the card).
IGNORED_KNOBS = ("frames_scan_unroll", "quad_builder", "splat_mode")

# The JAX serving overlay's key beyond the port's serving_config (its
# other two, frames_scan_unroll and quad_builder, are IGNORED_KNOBS): the
# renderer's frame-chunk remat off, forward only.
SERVING_PROFILE_EXEC = {"frames_scan_remat": False}


def _replace(ac: AvatarConfig, over: dict) -> AvatarConfig:
    """ac with the port's fields of `over` set; the ignored knobs dropped."""
    fields = {f.name for f in dataclasses.fields(AvatarConfig)}
    keep = {k: v for k, v in over.items() if k in fields}
    return dataclasses.replace(ac, **keep) if keep else ac


def _model_level_overrides(ac: AvatarConfig, cfg: Config) -> AvatarConfig:
    """Overlay scalar keys set directly under `model:` whose names are
    AvatarConfig fields (of the JAX package's, e.g. `model.demo_fuse_chunks=2`,
    `model.compute_dtype=bfloat16` from the CLI)."""
    m = cfg.get("model") or {}
    names = {f.name for f in dataclasses.fields(AvatarConfig)} | set(IGNORED_KNOBS)
    over = {k: v for k, v in dict(m).items()
            if k in names and not isinstance(v, dict)}
    return _replace(ac, over)


def build_avatar_config(cfg: Config) -> AvatarConfig:
    """Map the merged YAML tree onto the static AvatarConfig dataclass."""
    if cfg.get("profile") == "tiny":
        base = AvatarConfig.tiny(image_size=tuple(cfg.dataset.image_size))
        base = dataclasses.replace(
            base,
            audio_feature_dim=int(cfg.dataset.get("audio_feature_dim", 768)),
            num_expression_coeffs=int(cfg.dataset.get("num_expression_coeffs", 10)),
            flat_hand_mean=bool(cfg.dataset.get("flat_hand_mean", False)))
        # explicit YAML / CLI serving knobs apply on the tiny profile; the
        # scale fields stay pinned by the profile
        knobs = ("upsampler_sparse", "upsampler_sparse_max_tiles",
                 "upsampler_sparse_tile_px", "upsampler_sparse_penultimate",
                 "upsampler_sparse_pen_max_tiles", "upsampler_upconv",
                 "upsampler_conv", "upsampler_norm", "sample_slab", "sample_quad",
                 "splat_segmented", "splat_max_window", "splat_large_cap",
                 "frames_per_chunk", "frames_scan_remat",
                 "frames_scan_unroll", "rgb", "sh_degree",
                 "no_point_refiner")
        rd = (cfg.get("model") or {}).get("renderer", {})
        over = {k: rd[k] for k in knobs if k in rd}
        an = (cfg.get("model") or {}).get("triplane_audio_net", {})
        if "transformer_remat" in an:
            over["audio_transformer_remat"] = an["transformer_remat"]
        if "attn_impl" in an:
            over["audio_attn_impl"] = an["attn_impl"]
        return _model_level_overrides(_replace(base, over), cfg)

    m = cfg.model
    tn = m.triplane_net
    rd = m.renderer
    se = m.sapiens_encoder
    an = m.get("triplane_audio_net", {})
    ds = cfg.dataset
    ac = AvatarConfig(
        triplane_resolution=tn.triplane_resolution,
        triplane_feature_dim=tn.triplane_feature_dim,
        radius=tn.radius,
        smpl_token_len=tn.smpl_token_len,
        smpl_token_dim=tn.smpl_token_dim,
        smplx_transformer_layers=tn.smplx_transformer_layers,
        smplx_transformer_head_dim=tn.smplx_transformer_head_dim,
        smplx_transformer_num_heads=tn.smplx_transformer_num_heads,
        cross_transformer_layers=tn.cross_transformer_layers,
        cross_transformer_head_dim=tn.cross_transformer_head_dim,
        cross_transformer_num_heads=tn.cross_transformer_num_heads,
        sample_feature=tn.sample_feature,
        predict_smplx_params=tn.predict_smplx_params,
        upsample_triplane_encoder=tn.get("upsample_triplane", False),
        upsample_triplane=rd.upsample_triplane,
        num_upsample_blocks=rd.num_upsample_blocks,
        densify_smplx_verts=rd.densify_smplx_verts,
        subdivide_steps=rd.subdivide_steps,
        no_point_refiner=rd.get("no_point_refiner", False),
        image_size=tuple(ds.image_size),
        rgb=rd.get("rgb", True),
        sh_degree=rd.get("sh_degree", 0),
        max_per_tile=rd.get("max_per_tile", 512),
        upsampler_sparse=rd.get("upsampler_sparse", False),
        upsampler_sparse_max_tiles=rd.get("upsampler_sparse_max_tiles", 384),
        upsampler_sparse_tile_px=rd.get("upsampler_sparse_tile_px", 16),
        upsampler_sparse_penultimate=rd.get("upsampler_sparse_penultimate", False),
        upsampler_sparse_pen_max_tiles=rd.get("upsampler_sparse_pen_max_tiles", 128),
        upsampler_upconv=rd.get("upsampler_upconv", "poly"),
        upsampler_conv=rd.get("upsampler_conv", "xla"),
        upsampler_norm=rd.get("upsampler_norm", "group"),
        sample_slab=rd.get("sample_slab", False),
        sample_quad=rd.get("sample_quad", False),
        splat_segmented=rd.get("splat_segmented", False),
        splat_max_window=rd.get("splat_max_window", 4),
        splat_large_cap=rd.get("splat_large_cap", 0),
        frames_per_chunk=rd.get("frames_per_chunk", 1),
        frames_scan_remat=rd.get("frames_scan_remat", True),
        audio_transformer_remat=an.get("transformer_remat", True),
        audio_attn_impl=an.get("attn_impl", "flash"),
        image_feature_dim=se.image_feature_dim,
        vit_depth=se.get("vit_depth", 40),
        vit_heads=se.get("vit_heads", 24),
        vit_patch=se.get("vit_patch", 16),
        sapiens_resolution=se.get("sapiens_resolution", 1024),
        flat_hand_mean=ds.flat_hand_mean,
        num_expression_coeffs=ds.num_expression_coeffs,
        smplx_model_path=tn.get("smplx_model_path"),
        triplane_input_frames=an.get("triplane_input_frames", 2),
        triplane_output_frames=an.get("triplane_output_frames", 6),
        audio_transformer_layers=an.get("transformer_layers", 8),
        audio_transformer_head_dim=an.get("transformer_head_dim", 64),
        audio_transformer_num_heads=an.get("transformer_num_heads", 8),
        audio_feature_dim=an.get("audio_feature_dim", 768),
        ptv3_enc_channels=tuple(m.ptv3_encoder.enc_channels),
        ptv3_enc_depths=tuple(m.ptv3_encoder.enc_depths),
        ptv3_enc_heads=tuple(m.ptv3_encoder.enc_num_head),
        ptv3_dec_channels=tuple(m.ptv3_encoder.dec_channels),
        ptv3_dec_depths=tuple(m.ptv3_encoder.dec_depths),
        ptv3_dec_heads=tuple(m.ptv3_encoder.dec_num_head),
        ptv3_patch_size=m.ptv3_encoder.enc_patch_size[0],
        ptv3_grid_resolution=m.ptv3_encoder.grid_resolution,
        ptv3_output_dim=m.ptv3_encoder.output_dim,
    )
    return _model_level_overrides(ac, cfg)


def apply_serving_profile(ac: AvatarConfig, cfg: Config) -> AvatarConfig:
    """Overlay the serving profile onto `ac` for the inference entry points
    (demo), skipping keys the YAML's `model.renderer` (or, for the
    model-level keys, `model`) sets; the audio transformer's remat goes off
    unless `model.triplane_audio_net` sets it."""
    m = cfg.get("model") or {}
    rd = m.get("renderer", {}) if m else {}
    profile = dict(SERVING_PROFILE, **SERVING_PROFILE_EXEC)
    over = {k: v for k, v in profile.items() if k not in rd}
    over.update({k: v for k, v in SERVING_PROFILE_MODEL.items() if k not in m})
    an = m.get("triplane_audio_net", {}) if m else {}
    if "transformer_remat" not in an:
        over["audio_transformer_remat"] = False
    return _replace(ac, over)


def build_optim_config(cfg: Config) -> OptimConfig:
    t = cfg.training
    return OptimConfig(
        learning_rate=float(t.learning_rate),
        total_steps=int(t.total_steps),
        end_factor=float(t.scheduler.get("end_factor", 0.01)),
        betas=tuple(t.optimizer.get("betas", (0.9, 0.999))),
        weight_decay=float(t.optimizer.get("weight_decay", 0.0)),
        grad_clip=float(t.get("gradient_clip_val", 1.0)),
        accumulate_steps=int(t.get("gradient_accumulate_steps", 1)),
    )


def default_affine_norm_for_import(cfg, checkpoint_path):
    """An imported reference .ckpt file folds BatchNorm running stats into
    the upsampler's affine norm slots; running those params under GroupNorm
    would renormalize and discard the fold. Default
    model.renderer.upsampler_norm='affine' when a checkpoint file (not a
    directory) is given, unless the YAML / CLI set the knob."""
    if not checkpoint_path or os.path.isdir(str(checkpoint_path)):
        return cfg
    model = cfg.setdefault("model", type(cfg)())
    rd = model.setdefault("renderer", type(cfg)())
    if "upsampler_norm" not in rd:
        rd["upsampler_norm"] = "affine"
        print("[config] torch .ckpt import: defaulting "
              "model.renderer.upsampler_norm='affine' (folded BatchNorm)")
    return cfg
