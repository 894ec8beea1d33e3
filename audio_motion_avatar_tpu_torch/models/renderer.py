"""Renderer: triplane tokens -> 3D Gaussians -> splatted frames.

Low-res planes from the tokens; SMPL-X FK/LBS + midpoint subdivision +
frozen sub-selection -> body points; per frame chunk (frames_per_chunk
frames): the triplane upsampler, two triplane samplings around the PTv3
point refiner, the five gaussian heads as one fused matmul, and the splat.

The planes and their sampling, as the JAX package's Renderer selects them:
  * sparse (upsample_triplane and upsampler_sparse): the final upsample
    level on covered tiles only (with upsampler_sparse_penultimate the
    level below too), sampled by quad rows (sample_quad: ONE quad-row build,
    kernel Q, shared by both samplings; under autograd differentiated by
    kernel Q-bwd), else by 2x2 slabs of haloed tiles (sample_slab), else by
    four taps; the serving form is the quad one, typically with the
    segmented splat (kernel S); all three train;
  * dense (upsample_triplane): the full-resolution planes, sampled
    bilinearly (`sample_triplane_nhwc`); sample_quad / sample_slab are
    ignored there, as in the JAX package;
  * no upsampler (upsample_triplane False): the low-resolution planes
    relaid channel-last and sampled the same way.
splat_segmented picks the splat: kernel S, or the binned tile composite
K1 (ops/splat_tiles.py). upsampler_conv picks the upsampler's ResBlock
convs: direct ('xla'), Winograd K9a ('winograd') or, with the group norm,
K9b fused with it ('winograd_gn'). Colours: RGB (rgb), or with rgb False
3 (sh_degree + 1)^2 SH coefficients a gaussian, evaluated per view by the
splat (ops/splat.sh_colors); the sigmoid applies in both modes, as the
reference's. The forward returns (frames, gaussians) as the JAX renderer
does. Under autograd with cfg.frames_scan_remat (the
JAX package's nn.remat of its frame scan), each frame chunk is recomputed in
the backward (torch.utils.checkpoint) instead of keeping its upsampler,
refiner and splat activations: in the quad form a chunk builds its quad
rows twice (Q, the second time in the recompute) and transposes them once
(Q-bwd).

The stages are spans of the port's tracer (utils/profiling.py), each
entered once a chunk or more: render.body (FK/LBS, subdivision,
sub-selection), render.upsample, render.sample (the quad build or the
halo, and each sampling), render.refine (PTv3 and the refine MLP) and
render.splat (the fused heads to the frames: projection, binning, sort,
kernel S or K1).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import smplx as smplx_ops
from ..ops import subdivision
from ..ops import splat_tiles
from ..ops.math_utils import inverse_sigmoid
from ..ops.splat_segmented import render_frames_segmented
from ..ops.triplane import (build_quad, plane_grids, sample_triplane_nhwc,
                            sample_triplane_sparse, sample_triplane_sparse_quad,
                            sample_triplane_sparse_slab, tile_halo,
                            tokens_to_planes)
from ..utils import profiling
from .triplane_encoder import flatten_params
from .upsampler import TriplaneUpsampler

SUBDIVIDE_VERTS = {0: 10000, 1: 30000, 2: 30000}


class RendererStatics(NamedTuple):
    """Host-built geometry constants: the SMPL-X model (tensors on the
    device), subdivision tables and the frozen sub-selection indices."""

    smplx_model: smplx_ops.SmplxModel
    sub_tables: Optional[subdivision.SubdivisionTables]
    subselect: Optional[torch.Tensor]       # (num_points,) int64 on the device


def build_renderer_statics(model: smplx_ops.SmplxModel, device,
                           subdivide_steps: int = 2, densify: bool = True,
                           seed: int = 0) -> RendererStatics:
    """numpy SMPL-X model -> statics with the model's tensors on `device`."""
    tmodel = smplx_ops.as_tensors(model, device)
    if not densify:
        return RendererStatics(tmodel, None, None)
    nv = np.asarray(model.v_template).shape[0]
    tables = subdivision.build_subdivision(nv, np.asarray(model.faces),
                                           subdivide_steps)
    total = tables.num_verts[-1] if tables.num_verts else nv
    keep = min(SUBDIVIDE_VERTS[subdivide_steps], total)
    sel = subdivision.fixed_subselect(total, keep, seed=seed)
    return RendererStatics(tmodel, tables,
                           torch.as_tensor(sel.astype(np.int64), device=device))


class Renderer(nn.Module):
    def __init__(self, cfg, point_refiner: Optional[nn.Module] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.upsampler_upconv not in ("dilated", "poly"):
            raise ValueError(f"upsampler_upconv {cfg.upsampler_upconv!r} "
                             "('dilated' or 'poly', the same function)")
        self.cfg = cfg
        C = cfg.triplane_feature_dim
        if cfg.upsample_triplane:
            self.upsampler = TriplaneUpsampler(
                C, cfg.num_upsample_blocks, dtype=compute_dtype,
                sparse_final=cfg.upsampler_sparse,
                sparse_max_tiles=cfg.upsampler_sparse_max_tiles,
                sparse_tile_px=cfg.upsampler_sparse_tile_px,
                norm_mode=cfg.upsampler_norm, conv_impl=cfg.upsampler_conv,
                sparse_penultimate=cfg.upsampler_sparse_penultimate,
                sparse_pen_max_tiles=cfg.upsampler_sparse_pen_max_tiles)
        self.point_refiner = point_refiner
        if point_refiner is not None:
            self.refine_mlp = nn.Sequential(
                nn.Linear(cfg.ptv3_output_dim, 256), nn.ReLU(),
                nn.Linear(256, 256), nn.ReLU(), nn.Linear(256, 3))
        in_dim = C * 3 + 3
        self.xyz_layer = nn.Linear(in_dim, 3)
        self.rotation_layer = nn.Linear(in_dim, 4)
        self.scaling_layer = nn.Linear(in_dim, 3)
        self.opacity_layer = nn.Linear(in_dim, 1)
        # RGB: 3 channels; SH: 3 (deg + 1)^2 coefficients evaluated per view
        self.shs_dim = 3 if cfg.rgb else 3 * (cfg.sh_degree + 1) ** 2
        self.shs_layer = nn.Linear(in_dim, self.shs_dim)
        self.reset_heads()

    @torch.no_grad()
    def reset_heads(self) -> None:
        """The reference head init: zero kernels; biases xyz 0, rot
        [1, 0, 0, 0], scale -1, opacity inverse_sigmoid(0.1), shs 0; the
        refiner's offset layer starts at zero."""
        for layer in self._heads():
            layer.weight.zero_()
            layer.bias.zero_()
        self.rotation_layer.bias[0] = 1.0
        self.scaling_layer.bias.fill_(-1.0)
        self.opacity_layer.bias.fill_(inverse_sigmoid(0.1))
        if self.point_refiner is not None:
            self.refine_mlp[4].weight.zero_()
            self.refine_mlp[4].bias.zero_()

    def _heads(self):
        return (self.xyz_layer, self.rotation_layer, self.scaling_layer,
                self.opacity_layer, self.shs_layer)

    def get_vertices(self, statics: RendererStatics, smpl_params: dict):
        """SMPL-X forward + static densification -> (BT, N, 3) fp32."""
        with profiling.span("render.body"):
            verts = smplx_ops.forward(statics.smplx_model, smpl_params,
                                      flat_hand_mean=self.cfg.flat_hand_mean)
            if self.cfg.densify_smplx_verts and statics.sub_tables is not None:
                verts = subdivision.apply_subdivision(verts, statics.sub_tables)
                verts = verts[:, statics.subselect]
        return verts

    def _render_frame(self, planes_lr, points, transl, K, E):
        """One chunk: (F, 3, C, R, R) planes, (F, N, 3) points, (F, 1, 3)
        transl, (F, 3, 3) / (F, 4, 4) cameras -> (gaussians dict (F, N, ...),
        (F, H, W, 3) frames)."""
        cfg = self.cfg
        radius = cfg.radius
        if cfg.upsample_triplane and cfg.upsampler_sparse:
            with profiling.span("render.upsample"):
                uv = plane_grids(points, radius).reshape(points.shape[0], 3, -1, 2)
                planes = self.upsampler(planes_lr, points_uv=uv)
            if cfg.sample_quad:
                with profiling.span("render.sample"):
                    quad = build_quad(planes.tiles, planes.slot, planes.grid)

                def sample(p):
                    return sample_triplane_sparse_quad(planes, quad, p, radius)
            elif cfg.sample_slab:
                # the haloed tiles built once, shared by both samplings
                Fn, Pn = planes.tiles.shape[:2]
                with profiling.span("render.sample"):
                    th = tile_halo(planes.tiles.flatten(0, 1), planes.slot.flatten(0, 1),
                                   planes.grid)
                    th = th.reshape((Fn, Pn) + th.shape[1:])

                def sample(p):
                    return sample_triplane_sparse_slab(planes, th, p, radius)
            else:
                def sample(p):
                    return sample_triplane_sparse(planes, p, radius)
        else:
            if cfg.upsample_triplane:
                with profiling.span("render.upsample"):
                    planes = self.upsampler(planes_lr)            # (F, 3, H, W, C)
            else:
                planes = planes_lr.permute(0, 1, 3, 4, 2)         # (F, 3, R, R, C)

            def sample(p):
                return sample_triplane_nhwc(planes, p, radius)

        with profiling.span("render.sample"):
            feats = sample(points)
        if self.point_refiner is not None:
            with profiling.span("render.refine"):
                offsets = self.refine_mlp(self.point_refiner(points, feats))
                points = points + offsets
            with profiling.span("render.sample"):
                feats = sample(points)

        with profiling.span("render.splat"):
            dec_in = torch.cat([points, feats], -1)
            heads = self._heads()
            w = torch.cat([h.weight for h in heads], 0)           # (11 + shs, 3C + 3)
            b = torch.cat([h.bias for h in heads], 0)
            xyz_off, rot, scale, opacity, shs = torch.split(
                torch.nn.functional.linear(dec_in, w, b), [3, 4, 3, 1, self.shs_dim], -1)
            rot = rot / torch.clamp(torch.linalg.norm(rot, dim=-1, keepdim=True), min=1e-8)
            # colours through the sigmoid in both colour modes (reference quirk)
            gaussians = {"xyz": points + xyz_off + transl, "scale": scale,
                         "rot": rot, "opacity": opacity, "color": torch.sigmoid(shs)}
            H, W = cfg.image_size
            args = (gaussians["xyz"], rot, scale, opacity[..., 0], gaussians["color"],
                    K, E, W, H)
            sh_degree = None if cfg.rgb else cfg.sh_degree
            if cfg.splat_segmented:
                img = render_frames_segmented(
                    *args, max_per_tile=cfg.max_per_tile,
                    max_window=cfg.splat_max_window, large_cap=cfg.splat_large_cap,
                    sh_degree=sh_degree)
            else:
                img = splat_tiles.render_frames(*args, max_per_tile=cfg.max_per_tile,
                                                max_window=cfg.splat_max_window,
                                                sh_degree=sh_degree)
        return gaussians, img

    def forward(self, statics: RendererStatics, triplane_tokens: torch.Tensor,
                cam_params: dict, smpl_params: dict):
        """triplane tokens (B, T, C, 3RR), decoded params (B, T, ...) ->
        (rendered (B, T, H, W, 3), gaussians dict (BT, N, ...) with "shs" =
        "color"), frames_per_chunk frames at a time."""
        cfg = self.cfg
        B, T = triplane_tokens.shape[:2]
        BT = B * T
        planes_lr = tokens_to_planes(
            triplane_tokens.reshape((BT,) + triplane_tokens.shape[2:]),
            cfg.triplane_resolution)
        flat = flatten_params(smpl_params)
        points = self.get_vertices(statics, flat)
        transl = flat["transl"].reshape(BT, 1, 3)
        Ks = cam_params["intrinsic"].reshape(BT, 3, 3)
        Es = cam_params["extrinsic"].reshape(BT, 4, 4)
        F = cfg.frames_per_chunk
        if F <= 0 or BT % F:
            F = 1
        remat = cfg.frames_scan_remat and torch.is_grad_enabled()

        def frame(*args):
            if remat:
                return checkpoint(self._render_frame, *args, use_reentrant=False)
            return self._render_frame(*args)

        chunks = [frame(planes_lr[c:c + F], points[c:c + F], transl[c:c + F],
                        Ks[c:c + F], Es[c:c + F])
                  for c in range(0, BT, F)]
        gaussians = {k: torch.cat([g[k] for g, _ in chunks]) for k in chunks[0][0]}
        gaussians["shs"] = gaussians["color"]
        imgs = torch.cat([img for _, img in chunks])
        return imgs.reshape((B, T) + imgs.shape[1:]), gaussians
