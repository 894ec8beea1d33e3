"""Tiny cells for the CPU tests: the published configurations' files with
the port's tiny profile in place of their sizes, a 300-vertex body and
fp32 compute, at 32^2 (serving) or 64^2 (reconstruction)."""

from __future__ import annotations

import dataclasses

import torch

from benchmark.harness import HERE, Cell, load_json

TINY_SERVE = dict(num_upsample_blocks=2, max_per_tile=512, upsampler_sparse_max_tiles=3)


def tiny_cell(workload: str, config: str, traffic: str, **traffic_over) -> Cell:
    from audio_motion_avatar_tpu_torch.models.config import AvatarConfig

    cfg = load_json(HERE, "configs", f"{config}.json")
    tr = dict(load_json(HERE, "traffic", f"{traffic}.json"), **traffic_over)
    model = cfg["model"]
    tiny = AvatarConfig.tiny(image_size=tuple(tr["image_size"]))
    over = TINY_SERVE if tr["driver"] == "serve" else {}
    keep = ("upsampler_sparse", "splat_segmented", "splat_large_cap", "sample_quad",
            "upsampler_upconv", "frames_per_chunk", "gelu_approx", "upsampler_norm",
            "flat_hand_mean", "sample_feature", "frames_scan_remat", "audio_transformer_remat")
    fields = {f.name: getattr(tiny, f.name) for f in dataclasses.fields(AvatarConfig)}
    fields.update({k: model[k] for k in keep}, **over, compute_dtype="float32")
    fields.pop("smplx_model_path")
    cfg = dict(cfg, model={k: list(v) if isinstance(v, tuple) else v for k, v in fields.items()},
               body={"num_verts": 300})
    return Cell(workload, cfg, tr, load_json(HERE, "limits", f"{workload}.json"))


CPU = torch.device("cpu")
