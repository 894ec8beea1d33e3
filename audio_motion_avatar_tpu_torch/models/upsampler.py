"""Triplane upsampler: N x (nearest-2x + conv3x3 + ResBlock) with a
nearest-2x skip path, 32 -> 32 * 2^N, planes channels-last (NHWC).

Serving evaluates the final (most expensive) level only on the 16 px tiles
covered by the body's sample points plus a 1-tile halo (`sparse_final`):
exact on covered tiles with the affine norm; GroupNorm statistics pool over
the covered tiles there. `sparse_penultimate` does the same one level lower
and adds the covered tiles onto the skip background. The encoder's
`TriplaneDownsampler` (two ConvNeXt blocks and a strided conv) is here too. The nearest-2x + conv3x3 pair is computed as ONE
conv on the input-dilated plane (the JAX package's lhs_dilation=2, padding 2
conv with the 4x4 kernel T w T^T), written here as the equivalent stride-2
transposed conv with the spatially flipped kernel.

Norms: 'affine' (per-channel scale / bias, the inference form of the
reference BatchNorm once running stats are folded) or 'group' (GroupNorm(32),
eps 1e-6, statistics in fp32). Params fp32; convs run in the compute dtype.

The ResBlocks' 3x3 convs (conv_impl, the JAX package's selection rules):
'xla' runs them direct; 'winograd' through kernel K9a (ops/winograd.py),
SAME on the dense levels, VALID on the sparse final level's tile windows;
'winograd_gn' with the group norm on a dense level fuses each GroupNorm +
relu into its conv (kernel K9b on gn_affine's folded affine) and acts as
'winograd' elsewhere. A shape the kernels do not take runs the direct twin
(ops/winograd.conv3x3). The parameters are the same in every case.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import winograd
from ..ops.splat_segmented import top_k_lower_index

CONV_IMPLS = ("xla", "winograd", "winograd_gn")


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


def _cast(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return t if dtype is None else t.to(dtype)


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
    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None,
                 groups: int = 32, norm_mode: str = "group",
                 conv_impl: str = "xla"):
        super().__init__()
        if norm_mode not in ("group", "affine"):
            raise ValueError(f"norm_mode {norm_mode!r}")
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl {conv_impl!r} (one of {CONV_IMPLS})")
        self.dtype, self.groups, self.norm_mode = dtype, groups, norm_mode
        self.conv_impl = conv_impl
        self.norm1 = _NormParams(channels)
        self.conv1 = nn.Conv2d(channels, channels, 3)
        self.norm2 = _NormParams(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3)

    def _norm_relu(self, x: torch.Tensor, norm: _NormParams) -> torch.Tensor:
        if self.norm_mode == "affine":
            return torch.relu(x * _cast(norm.weight, self.dtype)
                              + _cast(norm.bias, self.dtype))
        y = F.group_norm(x.float().permute(0, 3, 1, 2), self.groups,
                         norm.weight, norm.bias, eps=1e-6)
        return torch.relu(_cast(y.permute(0, 2, 3, 1), self.dtype))

    def _conv(self, x, conv: nn.Conv2d, padding: int, gn=None):
        """conv3x3 of x (N, H, W, C), SAME (padding 1) or VALID (0); gn =
        (a, c): conv3x3(relu(a x + c)) (winograd_gn only)."""
        if self.conv_impl == "xla":
            return conv_nhwc(x, conv.weight, conv.bias, padding, self.dtype)
        w = _cast(conv.weight, self.dtype).permute(2, 3, 1, 0)     # HWIO
        return winograd.conv3x3(_cast(x, self.dtype), w, _cast(conv.bias, self.dtype),
                                "SAME" if padding == 1 else "VALID", gn)

    def _gn_relu_conv(self, x, norm: _NormParams, conv: nn.Conv2d):
        """Dense conv3x3(relu(GN(x))), the GroupNorm folded into a per-image
        affine and fused into the Winograd window assembly."""
        gn = winograd.gn_affine(x, norm.weight, norm.bias, self.groups)
        return self._conv(x, conv, 1, gn)

    def _fused_gn(self, x: torch.Tensor) -> bool:
        C = x.shape[-1]
        return (self.conv_impl == "winograd_gn" and self.norm_mode == "group"
                and winograd.supports_winograd(x.shape, C, C, "SAME"))

    def forward(self, x: torch.Tensor,
                sparse_ctx: Optional[SparseCtx] = None) -> torch.Tensor:
        """Dense: x (B, H, W, C). Sparse: x (F, cap, T+4, T+4, C) tile
        windows -> (F, cap, T, T, C) interiors."""
        if sparse_ctx is not None:
            return self._sparse(x, sparse_ctx)
        if self._fused_gn(x):
            h = self._gn_relu_conv(x, self.norm1, self.conv1)
            h = self._gn_relu_conv(h, self.norm2, self.conv2)
            return x + h
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
        if self.norm_mode == "affine":
            h = torch.relu(h * _cast(self.norm2.weight, h.dtype)
                           + _cast(self.norm2.bias, h.dtype))
        else:
            m2, v2 = masked_group_stats(h[:, :, 1:T + 1, 1:T + 1], ctx.valid,
                                        self.groups)
            h = torch.relu(apply_group_norm(h, m2, v2, self.norm2.weight,
                                            self.norm2.bias, self.groups))
        h = _mask2d(h, ctx.c1_rows, ctx.c1_cols)
        h = self._conv(h.reshape((Fn * cap,) + h.shape[2:]), self.conv2, 0)
        return u[:, :, 2:T + 2, 2:T + 2] + h.reshape((Fn, cap) + h.shape[1:])


class UpsampleBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None, norm_mode: str = "group",
                 conv_impl: str = "xla"):
        super().__init__()
        self.dtype = dtype
        self.conv_weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3))
        self.conv_bias = nn.Parameter(torch.zeros(out_channels))
        self.res = ResBlock(out_channels, dtype=dtype, norm_mode=norm_mode,
                            conv_impl=conv_impl)

    def forward(self, x: torch.Tensor,
                sparse_ctx: Optional[SparseCtx] = None) -> torch.Tensor:
        """Dense: (B, H, W, C) -> (B, 2H, 2W, C'). Sparse: (F, cap, Tin+4,
        Tin+4, C) haloed input patches -> (F, cap, 2 Tin, 2 Tin, C')."""
        if sparse_ctx is None:
            h = torch.relu(upsample2x_conv3x3_dilated(
                x, self.conv_weight, self.conv_bias, self.dtype))
            return self.res(h)
        Fn, cap, Pin = x.shape[:3]
        T = (Pin - 4) * 2
        h = upsample2x_conv3x3_dilated(x.reshape((Fn * cap,) + x.shape[2:]),
                                       self.conv_weight, self.conv_bias,
                                       self.dtype)
        h = h[:, 2:2 + T + 4, 2:2 + T + 4]
        h = torch.relu(h.reshape(Fn, cap, T + 4, T + 4, h.shape[-1]))
        h = _mask2d(h, sparse_ctx.u_rows, sparse_ctx.u_cols)
        return self.res(h, sparse_ctx)


class TriplaneUpsampler(nn.Module):
    """planes (B, 3, C, H, W) -> (B, 3, H', W', C) channels-last in the
    compute dtype, or SparseTriplanes when sparse_final and points_uv
    (B, 3, N, 2) are given. sparse_penultimate (with sparse_final and two
    blocks or more) also evaluates up_{N-2} on covered tiles only and adds
    them onto the nearest-2x skip background; the rest of that level holds
    the skip alone, read only through the final level's halo taps."""

    def __init__(self, feature_dim: int = 256, num_blocks: int = 4,
                 dtype: Optional[torch.dtype] = None,
                 sparse_final: bool = False, sparse_max_tiles: int = 384,
                 sparse_tile_px: int = 16, norm_mode: str = "group",
                 conv_impl: str = "xla", sparse_penultimate: bool = False,
                 sparse_pen_max_tiles: int = 128):
        super().__init__()
        self.feature_dim, self.num_blocks, self.dtype = feature_dim, num_blocks, dtype
        self.sparse_final = sparse_final
        self.sparse_max_tiles, self.sparse_tile_px = sparse_max_tiles, sparse_tile_px
        self.sparse_penultimate = sparse_penultimate
        self.sparse_pen_max_tiles = sparse_pen_max_tiles
        for i in range(num_blocks):
            self.add_module(f"up_{i}", UpsampleBlock(feature_dim, feature_dim,
                                                     dtype, norm_mode, conv_impl))
        self.skip_proj = nn.Conv2d(feature_dim, feature_dim, 1)

    def _skip_proj(self, skip):
        return conv_nhwc(skip, self.skip_proj.weight, self.skip_proj.bias, 0,
                         self.dtype)

    def forward(self, planes: torch.Tensor,
                points_uv: Optional[torch.Tensor] = None):
        B, P, C, H, W = planes.shape
        x = _cast(planes.reshape(B * P, C, H, W).permute(0, 2, 3, 1), self.dtype)
        sparse = self.sparse_final and points_uv is not None
        sparse_pen = sparse and self.sparse_penultimate and self.num_blocks >= 2
        n_dense = self.num_blocks - 1 - int(sparse_pen) if sparse else self.num_blocks
        skip = x
        for i in range(n_dense):
            up = getattr(self, f"up_{i}")(x)
            if i == 0:
                skip = self._skip_proj(skip)
            skip = nearest2x(skip)
            x = up + skip
        if not sparse:
            return x.reshape((B, P) + x.shape[1:])
        if sparse_pen:
            x, skip = self._sparse_scatter_level(x, skip, points_uv,
                                                 self.num_blocks - 2, n_dense == 0)
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

    def _sparse_scatter_level(self, x, skip, points_uv, level: int, first: bool):
        """The sparse penultimate level: up_{level} on covered tiles added
        onto the dense nearest-2x skip (a covered tile holds up + skip, as
        the dense recurrence; invalid slots alias tile 0 and add zeros).
        first: the level is block 0, so it projects the skip. -> (x (FP,
        2H, 2W, C), skip2x)."""
        FP = x.shape[0]
        if first:
            skip = self._skip_proj(skip)
        tiles, tile_ids, valid, _, _, grid, T, res = self._sparse_eval_level(
            x, points_uv, level, self.sparse_pen_max_tiles)
        skip2x = nearest2x(skip)
        Cn = tiles.shape[-1]
        tiles = tiles * valid[..., None, None, None].to(tiles.dtype)
        base = skip2x.reshape(FP, grid, T, grid, T, Cn).permute(0, 1, 3, 2, 4, 5)
        idx = tile_ids + grid * grid * torch.arange(FP, device=x.device)[:, None]
        out = base.reshape(FP * grid * grid, T, T, Cn).index_add(
            0, idx.reshape(-1), tiles.reshape((-1, T, T, Cn)))
        out = out.reshape(FP, grid, grid, T, T, Cn).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(FP, res, res, Cn), skip2x

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


class ConvNeXtBlock(nn.Module):
    """x + pw2(gelu(pw1(LayerNorm(dwconv7x7(x))))) on (B, H, W, C): a
    depthwise 7x7 conv, LayerNorm eps 1e-6, exact GELU, 4x expansion."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pw1 = nn.Linear(dim, 4 * dim)
        self.pw2 = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dwconv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return x + self.pw2(F.gelu(self.pw1(self.norm(h))))


class TriplaneDownsampler(nn.Module):
    """The encoder's learned downsample: planes (B, 3, C, H, W) -> two
    ConvNeXt blocks, then a 4x4 conv with stride `factor` and padding 1 ->
    (B, 3, C, H', W') (96 -> 32 at factor 3)."""

    def __init__(self, feature_dim: int = 256, factor: int = 3):
        super().__init__()
        self.block_0 = ConvNeXtBlock(feature_dim)
        self.block_1 = ConvNeXtBlock(feature_dim)
        self.down = nn.Conv2d(feature_dim, feature_dim, 4, stride=factor, padding=1)

    def forward(self, planes: torch.Tensor) -> torch.Tensor:
        B, P, C, H, W = planes.shape
        x = planes.reshape(B * P, C, H, W).permute(0, 2, 3, 1)
        x = self.block_1(self.block_0(x))
        out = self.down(x.permute(0, 3, 1, 2))
        return out.reshape((B, P, C) + out.shape[-2:])
