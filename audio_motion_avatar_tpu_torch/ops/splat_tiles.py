"""Tile splat: binned per-tile packing + the tile composite (kernel K1).

The default (non-serving) render path and the novel-view renders: the
counterpart of the tile half of the JAX package's ops/splat_pallas.py
(`_pack_tile_params`, `composite_tiles`, `render_tiles_pallas`,
`render_frames_pallas`) and of ops/splat.py's `render_tiles`,
`render_batch` and `render_multi_view`, which compute the same images.

Every view is binned on its own (`splat.bin_gaussians_sorted`) and packed
into (T, 9, K) tile blocks; the F views' blocks are stacked and composited
by ONE kernel launch, the tile origin taken from tile % tiles_per_frame.
On CUDA tensors `composite_tiles` launches K1 (csrc/splat_tiles.cu); on CPU
tensors it runs `composite_tiles_plain`, the same sequential blend
(splat.blend_tiles_plain). The JAX package's `_tile_origins` has no
counterpart: both versions derive a tile's origin from its index, as the
TPU kernel does.

Training differentiates the composite through `CompositeTiles`, the
counterpart of the JAX package's custom VJP (`_ct_fwd` / `_ct_bwd`): K1
forward, K2 (csrc/splat_tiles_bwd.cu, `composite_tiles_bwd`) backward,
saving only the packed params; on CPU tensors the same Function runs both
plain versions. The packing gather's autograd scatter-adds each tile's
gradient onto its gaussians.
"""

from __future__ import annotations

import math

import torch

from .. import kernels
from .cameras import make_camera
from .splat import (ALPHA_MAX, T_EPS, TILE, Projected, activate_opacity,
                    activate_scales, bin_gaussians_sorted, blend_tiles_plain,
                    project_gaussians, slot_alpha, tile_pixels, view_colors)
from .splat_segmented import NPARAM, P, tiles_to_image


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


def composite_tiles_plain(tile_params: torch.Tensor, tx: int,
                          tiles_per_frame: int = 0) -> torch.Tensor:
    """Plain version of K1 (splat.blend_tiles_plain over all K slots):
    (T, 9, K) -> (T, 256, 3)."""
    T, _, K = tile_params.shape
    return blend_tiles_plain(lambda j: tile_params[:, :, j].T, K, T, tx,
                             tiles_per_frame or T, tile_params.device,
                             tile_params.dtype)


def composite_tiles(tile_params: torch.Tensor, tx: int,
                    tiles_per_frame: int = 0) -> torch.Tensor:
    """K1 on CUDA tensors, its plain version on CPU tensors. tile_params
    (T, 9, K) float32; tiles_per_frame > 0: T is F stacked views of that
    many tiles each. -> (T, 256, 3) float32."""
    if tile_params.device.type == "cpu":
        return composite_tiles_plain(tile_params, tx, tiles_per_frame)
    if tile_params.device.type != "cuda":
        raise ValueError(f"composite_tiles: unsupported device {tile_params.device}")
    if tile_params.dtype != torch.float32 or tile_params.dim() != 3 or \
            tile_params.shape[1] != NPARAM or not tile_params.is_contiguous():
        raise ValueError("composite_tiles: tile_params must be contiguous "
                         f"(T, 9, K) float32, got {tuple(tile_params.shape)} "
                         f"{tile_params.dtype}")
    T, _, K = tile_params.shape
    out = torch.empty(T, P, 3, dtype=torch.float32, device=tile_params.device)
    lib = kernels.library("splat_tiles")
    rc = lib.splat_tiles_launch(tile_params.data_ptr(), T, K, tx,
                                tiles_per_frame or T, out.data_ptr(),
                                kernels.stream_ptr(tile_params.device))
    kernels.check(rc, "splat_tiles")
    composite_tiles.launches += 1
    composite_tiles.frames += T // (tiles_per_frame or T)
    return out


composite_tiles.launches = 0
composite_tiles.frames = 0   # frames composited by those launches

BWD_CHUNK = 64   # slots whose log-transmittance K2 keeps per pixel at a time


def composite_tiles_bwd_plain(tile_params: torch.Tensor, g: torch.Tensor,
                              tx: int, tiles_per_frame: int = 0) -> torch.Tensor:
    """Plain version of K2, the JAX package's `_tile_bwd_kernel` rule for
    rule, in K2's order: a forward sweep keeping each chunk's starting
    log-transmittance, then the chunks back to front, each rebuilt forward
    from its start and walked back to front with the suffix sum of G w.
    (T, 9, K) params, (T, 256, 3) output gradient -> d params (T, 9, K)."""
    T, _, K = tile_params.shape
    dt, dev = tile_params.dtype, tile_params.device
    px, py = tile_pixels(T, tx, tiles_per_frame or T, dev, dt)
    slot = [tile_params[:, :, j].T for j in range(K)]

    logT = torch.zeros(T, P, device=dev, dtype=dt)
    acc = torch.zeros(3, T, P, device=dev, dtype=dt)
    starts = []
    for j in range(K):
        if j % BWD_CHUNK == 0:
            starts.append(logT)
        alpha = slot_alpha(slot[j], px, py)[5]
        logT_after = logT + torch.log1p(-alpha)
        w = alpha * torch.exp(logT)
        w = torch.where(torch.exp(logT_after) < T_EPS, torch.zeros_like(w), w)
        acc = acc + w[None] * slot[j][6:9][:, :, None]
        logT = logT_after
    T_final = torch.exp(logT)
    pre = acc + T_final[None]
    gc = g.permute(2, 0, 1)
    gr, gg, gb = torch.where((pre > 0.0) & (pre < 1.0), gc, torch.zeros_like(gc))
    gT = gr + gg + gb
    bg = gT * T_final

    out = torch.zeros_like(tile_params)
    S = torch.zeros(T, P, device=dev, dtype=dt)
    zero = torch.zeros((), device=dev, dtype=dt)
    for c in range(len(starts) - 1, -1, -1):
        js = range(c * BWD_CHUNK, min(K, (c + 1) * BWD_CHUNK))
        lts, lg = {}, starts[c]
        for j in js:
            lts[j] = lg
            lg = lg + torch.log1p(-slot_alpha(slot[j], px, py)[5])
        for j in reversed(js):
            p = slot[j]
            dx, dy, power, e, araw, alpha, keep = slot_alpha(p, px, py)
            lb = lts[j]
            la = lb + torch.log1p(-alpha)
            Tb = torch.exp(lb)
            notcut = ~(torch.exp(la) < T_EPS)
            w = torch.where(notcut, alpha * Tb, zero)
            G = gr * p[6][:, None] + gg * p[7][:, None] + gb * p[8][:, None]
            dalpha = torch.where(notcut, G * Tb, zero) - (S + bg) / (1.0 - alpha)
            dalpha = torch.where(keep, dalpha, zero)
            S = S + G * w
            dar = torch.where(araw < ALPHA_MAX, dalpha, zero)
            dpow = torch.where(power < 0.0, dar * araw, zero)
            vals = (dpow * (p[2][:, None] * dx + p[3][:, None] * dy),
                    dpow * (p[4][:, None] * dy + p[3][:, None] * dx),
                    dpow * (-0.5 * dx * dx), dpow * (-dx * dy),
                    dpow * (-0.5 * dy * dy), dar * e, gr * w, gg * w, gb * w)
            out[:, :, j] = torch.stack([v.sum(1) for v in vals], 1)
    return out


def composite_tiles_bwd(tile_params: torch.Tensor, g: torch.Tensor, tx: int,
                        tiles_per_frame: int = 0) -> torch.Tensor:
    """K2 on CUDA tensors, its plain version on CPU tensors. tile_params
    (T, 9, K) and g (T, 256, 3) float32 -> d tile_params (T, 9, K)."""
    if tile_params.device.type == "cpu":
        return composite_tiles_bwd_plain(tile_params, g, tx, tiles_per_frame)
    if tile_params.device.type != "cuda":
        raise ValueError(f"composite_tiles_bwd: unsupported device {tile_params.device}")
    T, _, K = tile_params.shape
    for name, t, shape in (("tile_params", tile_params, (T, NPARAM, K)),
                           ("g", g, (T, P, 3))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or \
                not t.is_contiguous() or t.device != tile_params.device:
            raise ValueError(f"composite_tiles_bwd: {name} must be contiguous "
                             f"{shape} float32 on {tile_params.device}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    out = torch.empty_like(tile_params)
    lib = kernels.library("splat_tiles_bwd")
    rc = lib.splat_tiles_bwd_launch(tile_params.data_ptr(), g.data_ptr(), T, K, tx,
                                    tiles_per_frame or T, out.data_ptr(),
                                    kernels.stream_ptr(tile_params.device))
    kernels.check(rc, "splat_tiles_bwd")
    composite_tiles_bwd.launches += 1
    return out


composite_tiles_bwd.launches = 0


class CompositeTiles(torch.autograd.Function):
    """The tile composite under autograd: K1 forward, K2 backward (their
    plain versions on CPU tensors). Saves only the packed params."""

    @staticmethod
    def forward(ctx, tile_params, tx, tiles_per_frame):
        ctx.tx, ctx.tiles_per_frame = tx, tiles_per_frame
        ctx.save_for_backward(tile_params)
        return composite_tiles(tile_params, tx, tiles_per_frame)

    @staticmethod
    def backward(ctx, g):
        (tile_params,) = ctx.saved_tensors
        return (composite_tiles_bwd(tile_params, g.contiguous(), ctx.tx,
                                    ctx.tiles_per_frame), None, None)


def composite(tile_params: torch.Tensor, tx: int,
              tiles_per_frame: int = 0) -> torch.Tensor:
    """The composite, through CompositeTiles where a gradient will flow."""
    if torch.is_grad_enabled() and tile_params.requires_grad:
        return CompositeTiles.apply(tile_params, tx, tiles_per_frame)
    return composite_tiles(tile_params, tx, tiles_per_frame)


def render_frames(xyz: torch.Tensor, rot: torch.Tensor, raw_scales: torch.Tensor,
                  raw_opacity: torch.Tensor, colors: torch.Tensor,
                  K: torch.Tensor, E: torch.Tensor, width: int, height: int,
                  max_per_tile: int = 512, max_window: int = 8,
                  sh_degree=None) -> torch.Tensor:
    """F views of gaussians (F, N, ...) + cameras (F, 3, 3) / (F, 4, 4) ->
    images (F, H, W, 3): projection, per-view binning and packing, ONE
    composite launch over all views' tiles. White background; RGB colours,
    or with sh_degree set flat SH coefficients evaluated from each view's
    camera (splat.view_colors)."""
    if width % TILE or height % TILE:
        raise ValueError(f"image size {width}x{height} must be a multiple of {TILE}")
    tx, ty = width // TILE, height // TILE
    F = xyz.shape[0]
    o = raw_opacity[..., 0] if raw_opacity.dim() == 3 else raw_opacity
    cam = make_camera(K, E, width, height)
    proj = project_gaussians(xyz, rot, activate_scales(raw_scales),
                             activate_opacity(o),
                             view_colors(colors, xyz, cam, sh_degree), cam)
    packed = torch.cat([
        pack_tile_params(Projected(*(a[f] for a in proj)), width, height,
                         max_per_tile, max_window) for f in range(F)])
    tiles = composite(packed, tx, tx * ty)
    return tiles_to_image(tiles.reshape(F, tx * ty, P, 3), tx, ty)


def render_batch(gaussians: dict, K: torch.Tensor, E: torch.Tensor, width: int,
                 height: int, max_per_tile: int = 512,
                 max_window: int = 8, sh_degree=None) -> torch.Tensor:
    """Multi-view render: gaussians xyz / rot / scale / opacity / color
    (RGB, or flat SH coefficients with sh_degree set) with the cameras'
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
                         max_per_tile=max_per_tile, max_window=max_window,
                         sh_degree=sh_degree)
    return imgs.reshape(lead + (height, width, 3))


def render_multi_view(gaussians: dict, K: torch.Tensor, E: torch.Tensor,
                      width: int, height: int, **kw) -> torch.Tensor:
    """One gaussian set per batch entry (B, N, d) rendered from T cameras
    (B, T, ...) -> (B, T, H, W, 3)."""
    B, T = E.shape[:2]
    expanded = {k: v[:, None].expand((B, T) + v.shape[1:])
                for k, v in gaussians.items()}
    return render_batch(expanded, K, E, width, height, **kw)
