"""Static model configuration (copy of the JAX package's AvatarConfig).

One frozen dataclass carries every architecture knob; values default to the
reference YAML tree. `tiny()` is the scaled-down test profile and
`serving_config()` overlays the serving profile the JAX package applies to
its inference entry points (its configs/build.py SERVING_PROFILE and
SERVING_PROFILE_MODEL, copied here so the port imports nothing of it).

Of the JAX package's execution knobs the two remat switches are kept
(`frames_scan_remat`, `audio_transformer_remat`, both on by default as
there): under autograd the port checkpoints each renderer frame chunk and
each audio transformer block (torch.utils.checkpoint), and forward-only
calls ignore them. `audio_attn_impl` names the audio self-attention's
kernel as in the JAX package (flash, flash2, splash, serve, hpack): all
five compute the same function, kernel A's, and the port routes them
there; a train step refuses the four forward-only names. The others (scan
unroll, the splat and quad-row implementation selectors) compute the same
function whatever their value and are left out, so none can be set and
then ignored (configs/build.py drops them from a YAML). The render-path
knobs (quad or slab sampling, the sparse penultimate level, SH colours,
the planes without the upsampler) are all read by the renderer, and all
train; of them only splat_segmented (kernel S) is refused by a train step,
as it has no backward. The stage-1 fields
(sapiens_encoder, the triplane encoder's transformers) describe the model
the weights come from and are read by the stage-1 slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AvatarConfig:
    # triplane_net.yaml
    triplane_resolution: int = 32
    triplane_feature_dim: int = 256
    radius: float = 1.4
    smpl_token_len: int = 80
    smpl_token_dim: int = 256
    smplx_transformer_layers: int = 4
    smplx_transformer_head_dim: int = 64
    smplx_transformer_num_heads: int = 8
    cross_transformer_layers: int = 8
    cross_transformer_head_dim: int = 64
    cross_transformer_num_heads: int = 8
    sample_feature: bool = True
    predict_smplx_params: bool = True
    upsample_triplane_encoder: bool = False
    # renderer.yaml
    upsample_triplane: bool = True
    num_upsample_blocks: int = 4
    densify_smplx_verts: bool = True
    subdivide_steps: int = 2
    no_point_refiner: bool = False
    image_size: Tuple[int, int] = (1024, 1024)   # (H, W)
    rgb: bool = True
    sh_degree: int = 0
    max_per_tile: int = 512
    splat_segmented: bool = False
    splat_max_window: int = 4
    splat_large_cap: int = 0
    upsampler_sparse: bool = False
    upsampler_sparse_max_tiles: int = 384
    upsampler_sparse_tile_px: int = 16
    # sparse penultimate level too (added onto the dense skip background)
    upsampler_sparse_penultimate: bool = False
    upsampler_sparse_pen_max_tiles: int = 128
    upsampler_upconv: str = "poly"
    upsampler_conv: str = "xla"            # 'xla' | 'winograd' | 'winograd_gn'
    upsampler_norm: str = "group"
    sample_slab: bool = False     # sparse sampling by 2x2 slabs of haloed tiles
    sample_quad: bool = False     # sparse sampling by quad rows (kernel Q); before slab
    # sapiens_encoder.yaml
    image_feature_dim: int = 1536
    vit_depth: int = 40
    vit_heads: int = 24
    vit_patch: int = 16
    sapiens_resolution: int = 1024
    # dataset-coupled
    flat_hand_mean: bool = False
    num_expression_coeffs: int = 10
    smplx_model_path: Optional[str] = None
    # triplane_audio_net.yaml
    triplane_input_frames: int = 2
    triplane_output_frames: int = 6
    audio_transformer_layers: int = 8
    audio_transformer_head_dim: int = 64
    audio_transformer_num_heads: int = 8
    audio_feature_dim: int = 768
    # 'flash' | 'flash2' | 'splash' | 'serve' | 'hpack' (all kernel A here)
    audio_attn_impl: str = "flash"
    # ptv3_encoder.yaml
    ptv3_enc_channels: Tuple[int, ...] = (32, 64, 128, 256, 512)
    ptv3_enc_depths: Tuple[int, ...] = (2, 2, 2, 6, 2)
    ptv3_enc_heads: Tuple[int, ...] = (2, 4, 8, 16, 32)
    ptv3_dec_channels: Tuple[int, ...] = (256, 128, 256, 512)
    ptv3_dec_depths: Tuple[int, ...] = (2, 2, 2, 2)
    ptv3_dec_heads: Tuple[int, ...] = (4, 4, 8, 16)
    ptv3_patch_size: int = 512
    ptv3_grid_resolution: int = 100
    ptv3_output_dim: int = 256
    # the refiner's form: 'serial' (the TPU redesign: curve-window CPE, Dense
    # embed, window-4 pooling) or 'pointcept' (Pointcept's PT-v3m1 as the
    # reference runs it: sparse-conv stem and CPEs, grid pooling; port only)
    ptv3_form: str = "serial"
    # 'float32' | 'bfloat16': compute dtype of the transformer, refiner and
    # upsampler stacks (params stay fp32; geometry + splatting stay fp32)
    compute_dtype: str = "float32"
    frames_per_chunk: int = 1
    # recompute in the backward instead of keeping activations (training
    # only): each renderer frame chunk, each audio transformer block
    frames_scan_remat: bool = True
    audio_transformer_remat: bool = True
    # tanh-approximate GELU in the PTv3 refiner MLPs and the audio GEGLU
    gelu_approx: bool = False
    # demo: consecutive chunks rolled out in one call, the token window slid
    # inside it, one host transfer per group (the same math as one chunk a
    # call); 1 = one chunk a call
    demo_fuse_chunks: int = 1

    @classmethod
    def default(cls) -> "AvatarConfig":
        return cls()

    @classmethod
    def tiny(cls, image_size=(64, 64)) -> "AvatarConfig":
        """Small-everything profile: same topology, toy widths/depths."""
        return cls(
            triplane_resolution=8,
            triplane_feature_dim=32,
            smpl_token_len=8,
            smpl_token_dim=32,
            smplx_transformer_layers=1,
            smplx_transformer_head_dim=8,
            smplx_transformer_num_heads=2,
            cross_transformer_layers=1,
            cross_transformer_head_dim=8,
            cross_transformer_num_heads=2,
            num_upsample_blocks=1,
            subdivide_steps=0,
            image_size=image_size,
            image_feature_dim=48,
            vit_depth=1,
            vit_heads=2,
            vit_patch=8,
            sapiens_resolution=64,
            audio_transformer_layers=1,
            audio_transformer_head_dim=8,
            audio_transformer_num_heads=2,
            audio_feature_dim=16,
            ptv3_enc_channels=(16, 32),
            ptv3_enc_depths=(1, 1),
            ptv3_enc_heads=(2, 4),
            ptv3_dec_channels=(16,),
            ptv3_dec_depths=(1,),
            ptv3_dec_heads=(2,),
            ptv3_patch_size=64,
            ptv3_output_dim=256,
            max_per_tile=128,
        )


# Fields of the port that the JAX package's AvatarConfig does not have
# (their defaults select what the JAX package computes).
PORT_ONLY_FIELDS = {"ptv3_form": "serial"}


# The serving profile: forward-only knobs of the inference entry points
# (without the execution knobs left out above).
SERVING_PROFILE = {
    "upsampler_sparse": True,
    "upsampler_sparse_max_tiles": 256,
    "splat_segmented": True,
    "frames_per_chunk": 6,
    "sample_quad": True,
    "upsampler_upconv": "dilated",
    "splat_large_cap": 2048,
}

# Model-level serving keys.
SERVING_PROFILE_MODEL = {
    "gelu_approx": True,
}


def serving_config(base: Optional[AvatarConfig] = None,
                   **overrides) -> AvatarConfig:
    """`base` (default AvatarConfig()) with the serving profile applied,
    then `overrides` (e.g. image_size, compute_dtype, upsampler_norm)."""
    over = dict(SERVING_PROFILE)
    over.update(SERVING_PROFILE_MODEL)
    over.update(overrides)
    return dataclasses.replace(base if base is not None else AvatarConfig(),
                               **over)
