"""Triplane upsampler: N x (nearest-2x + conv3x3 + ResBlock) with a
nearest-2x skip path, 32 -> 32 * 2^N, planes channels-last (NHWC).

Serving evaluates the final (most expensive) level only on the 16 px tiles
covered by the body's sample points plus a 1-tile halo (`sparse_final`):
exact on covered tiles with the affine norm; GroupNorm statistics pool over
the covered tiles there. The nearest-2x + conv3x3 pair is computed as ONE
conv on the input-dilated plane (the JAX package's lhs_dilation=2, padding 2
conv with the 4x4 kernel T w T^T), written here as the equivalent stride-2
transposed conv with the spatially flipped kernel (the configurations'
'poly' and 'dilated' up-convs both compute this function).

Norms: 'affine' (per-channel scale / bias, the inference form of the
reference BatchNorm once running stats are folded) or 'group' (GroupNorm(32),
eps 1e-6, statistics in fp32). Params fp32; convs run in the compute dtype.
The ResBlocks' 3x3 convs are direct convolutions (the function of every
`upsampler_conv` the port offers).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.splat_segmented import top_k_lower_index


class SparseTriplanes(NamedTuple):
    """Covered tiles of the final level: tiles (B, 3, cap, T, T, C); slot
    (B, 3, G*G) tile -> slot (-1 holes); valid (B, 3, cap); grid G; tile_px
    T; res G*T; sorted_ids (B, 3, cap) ascending covered ids padded with
    G*G. Invalid slots hold finite values that no sampler reads."""

    tiles: torch.Tensor
    slot: torch.Tensor
    valid: torch.Tensor
    grid: int
    tile_px: int
    res: int
    sorted_ids: torch.Tensor


class SparseCtx(NamedTuple):
    valid: torch.Tensor      # (F, cap) bool
    u_rows: torch.Tensor     # (F, cap, T+4) in-plane rows of the u window
    u_cols: torch.Tensor     # (F, cap, T+4)
    c1_rows: torch.Tensor    # (F, cap, T+2)
    c1_cols: torch.Tensor    # (F, cap, T+2)


# applied to every operand that passes `_cast` (None: none); the
# benchmark's lower-precision control sets it (reference.entry)
OPERAND_ROUND = None


def _cast(t: Optional[torch.Tensor], dtype: Optional[torch.dtype]) -> torch.Tensor:
    if t is not None and OPERAND_ROUND is not None and t.is_floating_point():
        t = OPERAND_ROUND(t)
    return t if dtype is None or t is None else t.to(dtype)


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              padding: int, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """(N, H, W, C) x OIHW weight -> (N, H', W', O) in the compute dtype."""
    y = F.conv2d(_cast(x, dtype).permute(0, 3, 1, 2), _cast(weight, dtype),
                 _cast(bias, dtype), padding=padding)
    return y.permute(0, 2, 3, 1)


def nearest2x(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 2H, 2W, C)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def upsample2x_conv3x3_dilated(x: torch.Tensor, w: torch.Tensor,
                               b: torch.Tensor,
                               dtype: Optional[torch.dtype] = None):
    """conv3x3(SAME)(nearest2x(x)) as one conv: (B, H, W, C) + OIHW w ->
    (B, 2H, 2W, Co). K4 = T w T^T (T = [[1,0,0],[1,1,0],[0,1,1],[0,0,1]])
    applied to the 2x input-dilated, 2-padded plane equals a stride-2,
    padding-1 transposed conv with K4 flipped."""
    w, b = _cast(w, dtype), _cast(b, dtype)
    T4 = torch.tensor([[1., 0, 0], [1, 1, 0], [0, 1, 1], [0, 0, 1]],
                      dtype=w.dtype, device=w.device)
    K4 = torch.einsum("ur,vs,oirs->oiuv", T4, T4, w)         # (Co, C, 4, 4)
    wt = K4.flip(2, 3).transpose(0, 1)                      # (C, Co, 4, 4)
    y = F.conv_transpose2d(_cast(x, dtype).permute(0, 3, 1, 2), wt, b,
                           stride=2, padding=1)
    return y.permute(0, 2, 3, 1)


def _box3(cmap: torch.Tensor) -> torch.Tensor:
    """3x3 zero-padded box sum of (FP, G, G) integer-valued counts (exact)."""
    p = F.pad(cmap, (1, 1, 1, 1))
    G = cmap.shape[-1]
    return sum(p[:, dy:dy + G, dx:dx + G] for dy in range(3) for dx in range(3))


def select_tiles(points_uv: torch.Tensor, grid: int, cap: int,
                 tile_px: int = 16):
    """Covered-tile selection per plane: (FP, N, 2) uv in [-1, 1] ->
    (tile_ids (FP, cap), valid (FP, cap), slot (FP, G*G) with -1 holes,
    sorted_ids (FP, cap) ascending, invalid padded with G*G).

    A tile is covered if a point lands in it or its 3x3 neighbourhood; tiles
    are ranked by that dilated count (ties toward the lower id, as lax.top_k)
    so the least populated halo tiles drop first past `cap`. Slots follow
    ascending tile id, so slot[t] is t's rank among covered ids."""
    FP = points_uv.shape[0]
    G2 = grid * grid
    u = torch.clamp(points_uv, -1.0, 1.0)
    cell = torch.floor((u + 1.0) * (grid / 2.0) - 0.5 / tile_px)
    cx = torch.clamp(cell[..., 0], 0, grid - 1).long()
    cy = torch.clamp(cell[..., 1], 0, grid - 1).long()
    tid = cy * grid + cx
    counts = torch.zeros(FP, G2, dtype=torch.float32, device=u.device)
    counts.scatter_add_(1, tid, torch.ones_like(tid, dtype=torch.float32))
    prio = _box3(counts.reshape(FP, grid, grid)).reshape(FP, G2)
    topi = top_k_lower_index(prio, cap)
    topv = torch.gather(prio, 1, topi)
    sorted_ids = torch.sort(torch.where(topv > 0, topi, G2), dim=1).values
    valid = sorted_ids < G2
    tile_ids = torch.where(valid, sorted_ids, torch.zeros_like(sorted_ids))
    slot = torch.full((FP, G2 + 1), -1, dtype=torch.long, device=u.device)
    rank = torch.arange(cap, device=u.device).expand(FP, cap)
    slot.scatter_(1, sorted_ids, rank)          # sentinel column is dropped
    return tile_ids, valid, slot[:, :G2], sorted_ids


def gather_patches(x: torch.Tensor, tile_ids: torch.Tensor, grid: int,
                   in_tile: int, halo: int) -> torch.Tensor:
    """(FP, H, W, C) + (FP, cap) tile ids -> (FP, cap, P, P, C) patches,
    P = in_tile + 2 halo, zero-padded at the plane border."""
    FP = x.shape[0]
    P = in_tile + 2 * halo
    xp = F.pad(x, (0, 0, halo, halo, halo, halo))
    ar = torch.arange(P, device=x.device)
    rows = ((tile_ids // grid) * in_tile)[..., None] + ar        # (FP, cap, P)
    cols = ((tile_ids % grid) * in_tile)[..., None] + ar
    f = torch.arange(FP, device=x.device)[:, None, None, None]
    return xp[f, rows[:, :, :, None], cols[:, :, None, :]]


def masked_group_stats(x: torch.Tensor, valid: torch.Tensor, groups: int):
    """GroupNorm statistics over valid tiles' pixels: x (F, cap, T, T, C),
    valid (F, cap) -> mean, var (F, groups), one pass (E[x^2] - E[x]^2)."""
    Fn, cap, T, _, C = x.shape
    g = x.reshape(Fn, cap, T * T, groups, C // groups).float()
    w = valid.float()[:, :, None, None, None]
    n = torch.clamp(valid.sum(-1).float(), min=1.0)[:, None] * (T * T * (C // groups))
    gw = g * w
    mean = gw.sum(dim=(1, 2, 4)) / n
    var = torch.clamp((gw * g).sum(dim=(1, 2, 4)) / n - mean * mean, min=0.0)
    return mean, var


def apply_group_norm(x: torch.Tensor, mean, var, scale, bias, groups: int,
                     eps: float = 1e-6) -> torch.Tensor:
    Fn, cap, T, _, C = x.shape
    g = x.reshape(Fn, cap, T, T, groups, C // groups).float()
    g = (g - mean[:, None, None, None, :, None]) * torch.rsqrt(
        var[:, None, None, None, :, None] + eps)
    return (g.reshape(Fn, cap, T, T, C) * scale + bias).to(x.dtype)


def _mask2d(h: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor):
    return h * rows[:, :, :, None, None] * cols[:, :, None, :, None]


class _NormParams(nn.Module):
    """Per-channel scale / bias (the affine norm or GroupNorm's affine)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))


class ResBlock(nn.Module):
    """relu(norm1) -> conv1 -> relu(norm2) -> conv2, plus the input."""

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None,
                 groups: int = 32, norm_mode: str = "group"):
        super().__init__()
        if norm_mode not in ("group", "affine"):
            raise ValueError(f"norm_mode {norm_mode!r}")
        self.dtype, self.groups, self.norm_mode = dtype, groups, norm_mode
        self.norm1 = _NormParams(channels)
        self.conv1 = nn.Conv2d(channels, channels, 3)
        self.norm2 = _NormParams(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3)

    def _norm_relu(self, x: torch.Tensor, norm: _NormParams) -> torch.Tensor:
        if self.norm_mode == "affine":
            return torch.relu(x * _cast(norm.weight, self.dtype) + _cast(norm.bias, self.dtype))
        y = F.group_norm(x.float().permute(0, 3, 1, 2), self.groups, norm.weight, norm.bias,
                         eps=1e-6)
        return torch.relu(_cast(y.permute(0, 2, 3, 1), self.dtype))

    def _conv(self, x, conv: nn.Conv2d, padding: int):
        """conv3x3 of x (N, H, W, C), SAME (padding 1) or VALID (0)."""
        return conv_nhwc(x, conv.weight, conv.bias, padding, self.dtype)

    def forward(self, x: torch.Tensor,
                sparse_ctx: Optional[SparseCtx] = None) -> torch.Tensor:
        """Dense: x (B, H, W, C). Sparse: x (F, cap, T+4, T+4, C) tile
        windows -> (F, cap, T, T, C) interiors."""
        if sparse_ctx is not None:
            return self._sparse(x, sparse_ctx)
        h = self._conv(self._norm_relu(x, self.norm1), self.conv1, 1)
        h = self._conv(self._norm_relu(h, self.norm2), self.conv2, 1)
        return x + h

    def _sparse(self, u: torch.Tensor, ctx: SparseCtx) -> torch.Tensor:
        Fn, cap = u.shape[:2]
        T = u.shape[2] - 4
        if self.norm_mode == "affine":
            h = torch.relu(u * _cast(self.norm1.weight, u.dtype)
                           + _cast(self.norm1.bias, u.dtype))
        else:
            m1, v1 = masked_group_stats(u[:, :, 2:T + 2, 2:T + 2], ctx.valid,
                                        self.groups)
            h = torch.relu(apply_group_norm(u, m1, v1, self.norm1.weight,
                                            self.norm1.bias, self.groups))
        h = _mask2d(h, ctx.u_rows, ctx.u_cols)
        h = self._conv(h.reshape((Fn * cap,) + h.shape[2:]), self.conv1, 0)
        h = h.reshape((Fn, cap) + h.shape[1:])                    # T+2 windows
        scale, bias = self.norm2.weight, self.norm2.bias
        if self.norm_mode == "affine":
            h = torch.relu(h * _cast(scale, h.dtype) + _cast(bias, h.dtype))
        else:
            m2, v2 = masked_group_stats(h[:, :, 1:T + 1, 1:T + 1], ctx.valid, self.groups)
            h = torch.relu(apply_group_norm(h, m2, v2, scale, bias, self.groups))
        h = _mask2d(h, ctx.c1_rows, ctx.c1_cols)
        h = self._conv(h.reshape((Fn * cap,) + h.shape[2:]), self.conv2, 0)
        return u[:, :, 2:T + 2, 2:T + 2] + h.reshape((Fn, cap) + h.shape[1:])


class UpsampleBlock(nn.Module):
    """nearest-2x + conv3x3 (one fused conv), relu, ResBlock."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None, norm_mode: str = "group"):
        super().__init__()
        self.dtype = dtype
        self.conv_weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3))
        self.conv_bias = nn.Parameter(torch.zeros(out_channels))
        self.res = ResBlock(out_channels, dtype=dtype, norm_mode=norm_mode)

    def forward(self, x: torch.Tensor,
                sparse_ctx: Optional[SparseCtx] = None) -> torch.Tensor:
        """Dense: (B, H, W, C) -> (B, 2H, 2W, C'). Sparse: (F, cap, Tin+4,
        Tin+4, C) haloed input patches -> (F, cap, 2 Tin, 2 Tin, C')."""
        if sparse_ctx is None:
            return self.res(torch.relu(upsample2x_conv3x3_dilated(
                x, self.conv_weight, self.conv_bias, self.dtype)))
        Fn, cap, Pin = x.shape[:3]
        T = (Pin - 4) * 2
        h = upsample2x_conv3x3_dilated(x.reshape((Fn * cap,) + x.shape[2:]),
                                       self.conv_weight, self.conv_bias,
                                       self.dtype)
        h = torch.relu(h[:, 2:2 + T + 4, 2:2 + T + 4])
        h = h.reshape(Fn, cap, T + 4, T + 4, h.shape[-1])
        h = _mask2d(h, sparse_ctx.u_rows, sparse_ctx.u_cols)
        return self.res(h, sparse_ctx)


class TriplaneUpsampler(nn.Module):
    """planes (B, 3, C, H, W) -> (B, 3, H', W', C) channels-last in the
    compute dtype, or SparseTriplanes when sparse_final and points_uv
    (B, 3, N, 2) are given."""

    def __init__(self, feature_dim: int = 256, num_blocks: int = 4,
                 dtype: Optional[torch.dtype] = None,
                 sparse_final: bool = False, sparse_max_tiles: int = 384,
                 sparse_tile_px: int = 16, norm_mode: str = "group"):
        super().__init__()
        self.feature_dim, self.num_blocks, self.dtype = feature_dim, num_blocks, dtype
        self.sparse_final = sparse_final
        self.sparse_max_tiles, self.sparse_tile_px = sparse_max_tiles, sparse_tile_px
        for i in range(num_blocks):
            self.add_module(f"up_{i}", UpsampleBlock(feature_dim, feature_dim,
                                                     dtype, norm_mode))
        self.skip_proj = nn.Conv2d(feature_dim, feature_dim, 1)

    def _skip_proj(self, skip):
        return conv_nhwc(skip, self.skip_proj.weight, self.skip_proj.bias, 0,
                         self.dtype)

    def forward(self, planes: torch.Tensor,
                points_uv: Optional[torch.Tensor] = None):
        B, P, C, H, W = planes.shape
        x = _cast(planes.reshape(B * P, C, H, W).permute(0, 2, 3, 1), self.dtype)
        sparse = self.sparse_final and points_uv is not None
        n_dense = self.num_blocks - 1 if sparse else self.num_blocks
        skip = x
        for i in range(n_dense):
            up = getattr(self, f"up_{i}")(x)
            if i == 0:
                skip = self._skip_proj(skip)
            skip = nearest2x(skip)
            x = up + skip
        if not sparse:
            return x.reshape((B, P) + x.shape[1:])
        return self._sparse_final_level(x, skip, points_uv, B, P)

    def _sparse_eval_level(self, x, points_uv, level: int, cap_cfg: int):
        """Covered-tile selection at twice x's resolution, haloed input
        patches and up_{level} on them: x (FP, Hin, Hin, C) -> (tiles (FP,
        cap, T, T, C), tile_ids, valid, slot, sorted_ids, grid, T, res)."""
        FP, Hin = x.shape[:2]
        res = Hin * 2
        tile_px = min(self.sparse_tile_px, res)
        grid = res // tile_px
        cap = min(cap_cfg, grid * grid)
        tile_ids, valid, slot, sorted_ids = select_tiles(
            points_uv.reshape(FP, -1, 2), grid, cap, tile_px)
        patches = gather_patches(x, tile_ids, grid, tile_px // 2, 2)
        r0 = (tile_ids // grid) * tile_px
        c0 = (tile_ids % grid) * tile_px

        def axis_mask(base, extent, off):
            v = base[:, :, None] - off + torch.arange(extent, device=x.device)
            return ((v >= 0) & (v < res)).to(x.dtype)

        ctx = SparseCtx(valid=valid,
                        u_rows=axis_mask(r0, tile_px + 4, 2),
                        u_cols=axis_mask(c0, tile_px + 4, 2),
                        c1_rows=axis_mask(r0, tile_px + 2, 1),
                        c1_cols=axis_mask(c0, tile_px + 2, 1))
        tiles = getattr(self, f"up_{level}")(patches, ctx)
        return tiles, tile_ids, valid, slot, sorted_ids, grid, tile_px, res

    def _sparse_final_level(self, x, skip, points_uv, B, P):
        FP, _, _, C = x.shape
        if self.num_blocks == 1:      # the final block is also block 0
            skip = self._skip_proj(skip)
        res_tiles, tile_ids, valid, slot, sorted_ids, grid, tile_px, res = \
            self._sparse_eval_level(x, points_uv, self.num_blocks - 1,
                                    self.sparse_max_tiles)
        in_tile, cap = tile_px // 2, tile_ids.shape[1]
        skip_patches = gather_patches(skip, tile_ids, grid, in_tile, 0)
        skip2x = nearest2x(skip_patches.reshape(FP * cap, in_tile, in_tile, C))
        tiles = res_tiles + skip2x.reshape(FP, cap, tile_px, tile_px, C)
        Cn = tiles.shape[-1]
        return SparseTriplanes(
            tiles=tiles.reshape(B, P, cap, tile_px, tile_px, Cn),
            slot=slot.reshape(B, P, grid * grid),
            valid=valid.reshape(B, P, cap), grid=grid, tile_px=tile_px,
            res=res, sorted_ids=sorted_ids.reshape(B, P, cap))
