"""Static model configuration (copy of the JAX package's AvatarConfig).

One frozen dataclass carries every architecture knob; values default to the
reference YAML tree, and a configuration file may set any of them. The
reference computes the forms its configurations run (`check_supported`
refuses the others): the upsampler on the planes, dense or with a sparse
final level sampled through quad rows, RGB colours, the encoder's planes at
the triplane resolution. Knobs that pick an implementation of the same
function are accepted and read by nothing here: the up-conv form
(`upsampler_upconv`), the ResBlock convs (`upsampler_conv`), the audio
attention's kernel (`audio_attn_impl`), the remat switches (training only)
and the demo's chunk fusion.
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
    upsampler_conv: str = "xla"
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


def check_supported(cfg: AvatarConfig) -> AvatarConfig:
    """`cfg`, or a ValueError naming the first knob that selects a form the
    reference does not compute."""
    need = {"rgb": True, "upsample_triplane": True, "upsample_triplane_encoder": False,
            "upsampler_sparse_penultimate": False}
    if cfg.upsampler_sparse:
        need["sample_quad"] = True
    for key, value in need.items():
        if getattr(cfg, key) != value:
            raise ValueError(f"the reference computes {key}={value!r} only, "
                             f"not {getattr(cfg, key)!r}")
    return cfg
