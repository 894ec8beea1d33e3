"""Serving splat: sorted-segment binning + the segmented composite (kernel S).

Counterpart of the serving half of the JAX package's ops/splat_pallas.py
(`_pack_sorted_params`, `render_frames_segmented`, `_tiles_to_image`).

Binning is ONE stable sort of every frame's (tile, depth) candidates on a
composite int64 key — frame and tile id in the high 32 bits, the
order-preserving bits of the f32 depth in the low 32 — after which the
gaussian payload is gathered. Within a tile this is depth-ascending order
with equal depths in candidate emission order, as the JAX value-carrying
sort gives. Tile t owns the segment [starts[t], starts[t] + counts[t]) of
the (9, NP) payload, counts clamped to K = max_per_tile.

Two-tier binning (large_cap > 0): every gaussian emits a 2x2 tile block,
and the large_cap largest-radius gaussians spanning more tiles emit the full
max_window block instead. The top-k breaks radius ties toward the lower
index, as lax.top_k does (torch.topk does not promise it).
"""

from __future__ import annotations

import torch

from .calls import logged
from .cameras import make_camera
from .splat import (TILE, Projected, activate_opacity, activate_scales,
                    blend_tiles_plain, project_gaussians, view_colors)

P = TILE * TILE   # pixels per tile
NPARAM = 9        # mx, my, cxx, cxy, cyy, opacity, r, g, b


def _depth_key(depth: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 in [0, 2^32), monotone in the float value (-0 == +0)."""
    bits = (depth + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(bits >= 0x80000000, 0xFFFFFFFF - bits,
                       bits | 0x80000000)


def top_k_lower_index(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last dim, ties toward
    the lower index (the lax.top_k order)."""
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k]


def pack_sorted_params(proj: Projected, width: int, height: int,
                       max_per_tile: int, max_window: int,
                       large_cap: int = 0, small_window: int = 2):
    """Frames-batched binning: proj fields (F, N, ...) ->
    (params (9, F*NP) f32, starts (F*T,) i32, counts (F*T,) i32) with
    T = (H/16)(W/16) tiles per frame, frame-major."""
    tx, ty = width // TILE, height // TILE
    n_tiles = tx * ty
    F, n = proj.depth.shape
    K = min(max_per_tile, n)
    dev = proj.depth.device
    zero = torch.zeros_like(proj.depth)
    radius = torch.where(proj.valid, proj.radius, zero)
    opac = torch.where(proj.valid, proj.opacity, zero)
    depth = torch.where(proj.valid, proj.depth, zero)
    mean2d, conic, color = proj.mean2d, proj.conic, proj.color

    x0r = torch.floor((mean2d[..., 0] - radius) / TILE)
    x1r = torch.floor((mean2d[..., 0] + radius) / TILE)
    y0r = torch.floor((mean2d[..., 1] - radius) / TILE)
    y1r = torch.floor((mean2d[..., 1] + radius) / TILE)
    alive = (radius > 0) & (x1r >= 0) & (x0r <= tx - 1) & (y1r >= 0) & \
        (y0r <= ty - 1)
    x0 = x0r.clamp(0, tx - 1).long()
    x1 = x1r.clamp(0, tx - 1).long()
    y0 = y0r.clamp(0, ty - 1).long()
    y1 = y1r.clamp(0, ty - 1).long()

    def emit(x0e, y0e, x1e, y1e, alive_e, W):
        off = torch.arange(W, device=dev)
        gx = x0e[..., None] + off
        gy = y0e[..., None] + off
        vx = (gx <= x1e[..., None]) & (gx < tx)
        vy = (gy <= y1e[..., None]) & (gy < ty)
        tile_id = gy[..., :, None] * tx + gx[..., None, :]        # (F, m, W, W)
        valid = vy[..., :, None] & vx[..., None, :] & alive_e[..., None, None]
        return torch.where(valid, tile_id, n_tiles).reshape(F, -1)

    def rep(v, W):   # (F, m, c) -> (F, c, m*W*W)
        return v.repeat_interleave(W * W, dim=1).transpose(1, 2)

    # depth rides along as payload row 0 (the low sort key), params after it
    cols = torch.cat([depth[..., None], mean2d, conic, opac[..., None],
                      color], -1)                                  # (F, n, 10)
    two_tier = large_cap > 0 and max_window > small_window and large_cap < n
    if not two_tier:
        key = emit(x0, y0, x1, y1, alive, max_window)
        payload = rep(cols, max_window)
    else:
        WS, WL = small_window, max_window
        span_big = ((x1 - x0) >= WS) | ((y1 - y0) >= WS)
        score = torch.where(span_big & alive, radius,
                            torch.full_like(radius, -1.0))
        bidx = top_k_lower_index(score, large_cap)                 # (F, KL)
        sel = torch.gather(score, 1, bidx) > 0
        is_b = torch.zeros_like(alive).scatter(1, bidx, sel)

        def g(v):
            return torch.gather(v, 1, bidx)

        key = torch.cat([emit(x0, y0, x1, y1, alive & ~is_b, WS),
                         emit(g(x0), g(y0), g(x1), g(y1), sel, WL)], 1)
        cols_b = torch.gather(cols, 1, bidx[..., None].expand(-1, -1, cols.shape[-1]))
        payload = torch.cat([rep(cols, WS), rep(cols_b, WL)], 2)
    NP = key.shape[1]

    frame = torch.arange(F, device=dev)[:, None] * (n_tiles + 1)
    full_key = ((frame + key) << 32) | _depth_key(payload[:, 0])
    full_key = full_key.reshape(-1)
    keys_sorted, order = torch.sort(full_key, stable=True)
    params = payload[:, 1:].permute(1, 0, 2).reshape(NPARAM, F * NP)
    params = params[:, order].contiguous()

    bounds_q = ((frame + torch.arange(n_tiles + 1, device=dev)) << 32).reshape(-1)
    bounds = torch.searchsorted(keys_sorted, bounds_q).reshape(F, n_tiles + 1)
    starts = bounds[:, :-1]
    counts = torch.clamp(bounds[:, 1:] - starts, max=K)
    return (params, starts.reshape(-1).to(torch.int32),
            counts.reshape(-1).to(torch.int32))


@logged("composite_segments")
def composite_segments_plain(params: torch.Tensor, starts: torch.Tensor,
                             counts: torch.Tensor, tx: int,
                             tiles_per_frame: int) -> torch.Tensor:
    """Plain version of kernel S (splat.blend_tiles_plain), one segment
    position per step. (9, NP), (T,), (T,) -> (T, 256, 3)."""
    T = starts.shape[0]
    starts64, counts64 = starts.long(), counts.long()

    def slot(j):
        live = j < counts64
        g = params[:, torch.where(live, starts64 + j, 0)]          # (9, T)
        return torch.cat([g[:5], torch.where(live, g[5], torch.zeros_like(g[5]))[None],
                          g[6:]])

    kmax = int(counts.max()) if T else 0
    return blend_tiles_plain(slot, kmax, T, tx, tiles_per_frame, params.device)


def tiles_to_image(tiles: torch.Tensor, tx: int, ty: int) -> torch.Tensor:
    """(..., T, 256, 3) tile-major -> (..., H, W, 3)."""
    lead = tiles.shape[:-3]
    img = tiles.reshape(*lead, ty, tx, TILE, TILE, 3)
    img = img.transpose(-4, -3)
    return img.reshape(*lead, ty * TILE, tx * TILE, 3)


def pack_frames_segmented(xyz: torch.Tensor, rot: torch.Tensor,
                          raw_scales: torch.Tensor, raw_opacity: torch.Tensor,
                          colors: torch.Tensor, K: torch.Tensor, E: torch.Tensor,
                          width: int, height: int, max_per_tile: int = 512,
                          max_window: int = 8, large_cap: int = 0):
    """F frames of gaussians (F, N, ...) + cameras (F, 3, 3)/(F, 4, 4) ->
    kernel S's inputs (params, starts, counts): projection and sorted
    binning, RGB colours."""
    if width % TILE or height % TILE:
        raise ValueError(f"image size {width}x{height} must be a multiple of {TILE}")
    cam = make_camera(K, E, width, height)
    o = raw_opacity[..., 0] if raw_opacity.dim() == 3 else raw_opacity
    proj = project_gaussians(xyz, rot, activate_scales(raw_scales),
                             activate_opacity(o),
                             view_colors(colors), cam)
    return pack_sorted_params(proj, width, height, max_per_tile, max_window,
                              large_cap=large_cap)


def render_frames_segmented(xyz: torch.Tensor, rot: torch.Tensor,
                            raw_scales: torch.Tensor,
                            raw_opacity: torch.Tensor, colors: torch.Tensor,
                            K: torch.Tensor, E: torch.Tensor, width: int,
                            height: int, max_per_tile: int = 512,
                            max_window: int = 8, large_cap: int = 0) -> torch.Tensor:
    """F frames of gaussians (F, N, ...) + cameras (F, 3, 3)/(F, 4, 4) ->
    images (F, H, W, 3): projection, sorted binning and ONE composite
    launch over all frames' tiles. Colours as `pack_frames_segmented`."""
    params, starts, counts = pack_frames_segmented(
        xyz, rot, raw_scales, raw_opacity, colors, K, E, width, height,
        max_per_tile, max_window, large_cap)
    tx, ty = width // TILE, height // TILE
    tiles = composite_segments_plain(params, starts, counts, tx, tx * ty)
    return tiles_to_image(tiles.reshape(xyz.shape[0], tx * ty, P, 3), tx, ty)
