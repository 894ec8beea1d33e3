"""Tile splat: binned per-tile packing + the tile composite (kernel K1).

The default (non-serving) render path and the novel-view renders: the
counterpart of the tile half of the JAX package's ops/splat_pallas.py
(`_pack_tile_params`, `composite_tiles`, `render_tiles_pallas`,
`render_frames_pallas`) and of ops/splat.py's `render_tiles`,
`render_batch` and `render_multi_view`, which compute the same images.

Every view is binned on its own (`splat.bin_gaussians_sorted`) and packed
into (T, 9, K) tile blocks; the F views' blocks are stacked and composited
together, the tile origin taken from tile % tiles_per_frame, by
`composite_tiles_plain`, the sequential blend (splat.blend_tiles_plain),
where the port launches kernel K1.
"""

from __future__ import annotations

import math

import torch

from .calls import logged
from .cameras import make_camera
from .splat import (TILE, Projected, activate_opacity, activate_scales,
                    bin_gaussians_sorted, blend_tiles_plain, project_gaussians,
                    view_colors)
from .splat_segmented import P, tiles_to_image


def pack_tile_params(proj: Projected, width: int, height: int,
                     max_per_tile: int, max_window: int) -> torch.Tensor:
    """Binning + per-tile packing of ONE view (proj fields (N, ...)) ->
    (T, 9, K) [mx, my, cxx, cxy, cyy, op, r, g, b] of each tile's first K
    depth-ordered gaussians, opacity 0 in the padding slots."""
    order, tile_idx, tile_mask = bin_gaussians_sorted(
        proj, width, height, max_per_tile, max_window=max_window)
    mean2d, conic, color = proj.mean2d[order], proj.conic[order], proj.color[order]
    opac = torch.where(proj.valid[order], proj.opacity[order],
                       torch.zeros_like(proj.opacity[order]))
    packed = torch.stack([mean2d[:, 0], mean2d[:, 1], conic[:, 0], conic[:, 1],
                          conic[:, 2], opac, color[:, 0], color[:, 1],
                          color[:, 2]], 0)                         # (9, N)
    tile_params = packed[:, tile_idx].transpose(0, 1).contiguous()  # (T, 9, K)
    tile_params[:, 5] *= tile_mask.to(packed.dtype)
    return tile_params


@logged("composite_tiles")
def composite_tiles_plain(tile_params: torch.Tensor, tx: int,
                          tiles_per_frame: int = 0) -> torch.Tensor:
    """Plain version of K1 (splat.blend_tiles_plain over all K slots):
    (T, 9, K) -> (T, 256, 3)."""
    T, _, K = tile_params.shape
    return blend_tiles_plain(lambda j: tile_params[:, :, j].T, K, T, tx,
                             tiles_per_frame or T, tile_params.device,
                             tile_params.dtype)


def render_frames(xyz: torch.Tensor, rot: torch.Tensor, raw_scales: torch.Tensor,
                  raw_opacity: torch.Tensor, colors: torch.Tensor,
                  K: torch.Tensor, E: torch.Tensor, width: int, height: int,
                  max_per_tile: int = 512, max_window: int = 8) -> torch.Tensor:
    """F views of gaussians (F, N, ...) + cameras (F, 3, 3) / (F, 4, 4) ->
    images (F, H, W, 3): projection, per-view binning and packing, ONE
    composite over all views' tiles. White background, RGB colours."""
    if width % TILE or height % TILE:
        raise ValueError(f"image size {width}x{height} must be a multiple of {TILE}")
    tx, ty = width // TILE, height // TILE
    F = xyz.shape[0]
    o = raw_opacity[..., 0] if raw_opacity.dim() == 3 else raw_opacity
    cam = make_camera(K, E, width, height)
    proj = project_gaussians(xyz, rot, activate_scales(raw_scales),
                             activate_opacity(o),
                             view_colors(colors), cam)
    packed = torch.cat([
        pack_tile_params(Projected(*(a[f] for a in proj)), width, height,
                         max_per_tile, max_window) for f in range(F)])
    tiles = composite_tiles_plain(packed, tx, tx * ty)
    return tiles_to_image(tiles.reshape(F, tx * ty, P, 3), tx, ty)


def render_batch(gaussians: dict, K: torch.Tensor, E: torch.Tensor, width: int,
                 height: int, max_per_tile: int = 512,
                 max_window: int = 8) -> torch.Tensor:
    """Multi-view render: gaussians xyz / rot / scale / opacity / color
    (RGB) with the cameras'
    leading dims (..., N, d), K (..., 3, 3), E (..., 4, 4) -> (..., H, W,
    3), every view in one composite launch."""
    lead = tuple(E.shape[:-2])
    n = math.prod(lead)

    def flat(v, last):
        return v.reshape((n, -1, last))

    imgs = render_frames(flat(gaussians["xyz"], 3), flat(gaussians["rot"], 4),
                         flat(gaussians["scale"], 3),
                         gaussians["opacity"].reshape(n, -1),
                         flat(gaussians["color"], gaussians["color"].shape[-1]),
                         K.reshape(n, 3, 3), E.reshape(n, 4, 4), width, height,
                         max_per_tile=max_per_tile, max_window=max_window)
    return imgs.reshape(lead + (height, width, 3))


def render_multi_view(gaussians: dict, K: torch.Tensor, E: torch.Tensor,
                      width: int, height: int, **kw) -> torch.Tensor:
    """One gaussian set per batch entry (B, N, d) rendered from T cameras
    (B, T, ...) -> (B, T, H, W, 3)."""
    B, T = E.shape[:2]
    expanded = {k: v[:, None].expand((B, T) + v.shape[1:])
                for k, v in gaussians.items()}
    return render_batch(expanded, K, E, width, height, **kw)
