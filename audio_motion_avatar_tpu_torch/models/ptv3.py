"""PointTransformer-V3-style point refiner, batched over clouds.

Space-filling-curve serialization (z / z-trans / hilbert / hilbert-trans)
alternating across blocks; dense multi-head attention inside patches of
`patch_size` consecutive points along the curve; a depthwise window-3 conv
along the curve as the positional encoding (xCPE); fixed-window (4) max
pooling on the z curve; U-Net decoder with skip connections. Point counts
are padded to a multiple of the patch size and masked (valid first).
Argsorts are stable and codes int32, as the JAX package's; a level's codes
in every order come from one call (`ops/serialization.sfc_codes`, kernel SFC
on the card) and one stable sort over all of them.

Patch attention with head width 64 (the decoder's first stage at serving
widths) runs through kernel A with a key mask; narrower heads use the dense
chain in the compute dtype, as the JAX package does.

That is the serial form (`ptv3_form: "serial"`, the default). The published
form, Pointcept's PT-v3m1 (`ptv3_form: "pointcept"`), is `PointceptUNet`
below: sparse-conv stem and CPEs (kernel SC), grid pooling, BatchNorm.

Tensor parallelism (parallel/mesh.shard_model): the patch attention splits
its heads over 'model' (query / key / value column-parallel with their
biases, out row-parallel) and the MLP pair its hidden width, as the JAX
package annotates them ('heads', 'mlp').
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import serialization as ser
from ..ops import sparse_conv as sc
from ..ops.attention import KERNEL_HEAD_DIM, dense_attention
from ..parallel.tensor import ModelAxis, copy_to_model
from ..utils import profiling
from .transformer import (LayerNorm, head_attention, linear, merge_heads, row_linear,
                          split_heads)

POOL_WINDOW = 4


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-cloud row gather: x (B, N, ...) , idx (B, M) -> (B, M, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def invert_perm(perm: torch.Tensor) -> torch.Tensor:
    """(B, N) permutations -> their inverses (one scatter)."""
    n = perm.shape[1]
    ar = torch.arange(n, device=perm.device).expand_as(perm)
    return torch.empty_like(perm).scatter_(1, perm, ar)


def _orders(pts: torch.Tensor, mask: torch.Tensor, grid_resolution: float,
            names: Sequence[str]) -> dict:
    """{order: (perm, inv)} of one level: every order's codes at once
    (`ser.sfc_codes`), one stable sort and one inverse for all of them."""
    codes = ser.sfc_codes(pts.contiguous(), mask, grid_resolution, names)
    K, B, N = codes.shape
    perm = torch.argsort(codes.reshape(K * B, N), dim=1, stable=True)
    inv = invert_perm(perm)
    perm, inv = perm.view(K, B, N), inv.view(K, B, N)
    return {o: (perm[k], inv[k]) for k, o in enumerate(names)}


class _SerialCpe(nn.Module):
    """Depthwise window-3 conv along the curve (SAME padding)."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dim, 1, 3))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        x = x.to(dt)
        k = self.weight[:, 0, :].to(dt)                          # (C, 3)
        N = x.shape[1]
        xp = F.pad(x, (0, 0, 1, 1))
        return (xp[:, 0:N] * k[:, 0] + xp[:, 1:N + 1] * k[:, 1]
                + xp[:, 2:N + 2] * k[:, 2] + self.bias.to(dt))


class _PatchAttention(nn.Module):
    """flax MultiHeadDotProductAttention over patches, with biases. Sharded
    over 'model' (tp), it holds heads / n heads."""

    tp: Optional[ModelAxis] = None

    def __init__(self, dim: int, heads: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.heads, self.head_dim, self.dtype = heads, dim // heads, dtype
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, hq: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """hq (G, P, C), mask (G, P) bool valid keys -> (G, P, C)."""
        hq = copy_to_model(hq, self.tp)
        heads = self.query.weight.shape[0] // self.head_dim      # this rank's
        q = split_heads(linear(hq, self.query, self.dtype), heads)
        k = split_heads(linear(hq, self.key, self.dtype), heads)
        v = split_heads(linear(hq, self.value, self.dtype), heads)
        D = q.shape[-1]
        if D == KERNEL_HEAD_DIM:
            out = head_attention(q, k, v, D ** -0.5, mask)
        else:
            out = self.dense(q, k, v, mask)
        return row_linear(merge_heads(out), self.out, self.dtype, self.tp)

    @staticmethod
    def dense(q, k, v, mask):
        """The dense chain of heads narrower than kernel A's, in the compute
        dtype (q scaled first, as flax does)."""
        D = q.shape[-1]
        return dense_attention(q / torch.tensor(math.sqrt(D), dtype=q.dtype), k, v, 1.0, mask)


class _PointceptAttention(_PatchAttention):
    """Pointcept's patch attention (upcast_attention / upcast_softmax): the
    dense chain's logits and softmax in fp32, the probabilities rounded to
    the compute dtype for P V; head width 64 through kernel A."""

    @staticmethod
    def dense(q, k, v, mask):
        return dense_attention(q, k, v, q.shape[-1] ** -0.5, mask, softmax_dtype=torch.float32)


class SerialBlock(nn.Module):
    """xCPE + patch attention + MLP, pre-LN, masked residuals; tp: the MLP
    pair's hidden width sharded over 'model'."""

    tp: Optional[ModelAxis] = None

    def __init__(self, dim: int, heads: int, patch_size: int,
                 dtype: Optional[torch.dtype] = None, gelu_approx: bool = False):
        super().__init__()
        self.patch_size, self.dtype = patch_size, dtype
        self.approximate = "tanh" if gelu_approx else "none"
        self.cpe = _SerialCpe(dim, dtype)
        self.ln1 = LayerNorm(dim, dtype)
        self.attn = _PatchAttention(dim, heads, dtype)
        self.ln2 = LayerNorm(dim, dtype)
        self.mlp1 = nn.Linear(dim, dim * 4)
        self.mlp2 = nn.Linear(dim * 4, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x (B, N, C) curve-ordered; mask (N,) bool valid."""
        B, N, C = x.shape
        m = mask[None, :, None]
        x = x + self.cpe(x) * m
        p = min(self.patch_size, N)
        g = N // p
        h = self.ln1(x)
        attn = self.attn(h.reshape(B * g, p, C),
                         mask.reshape(1, g, p).expand(B, g, p).reshape(B * g, p))
        x = x + attn.reshape(B, N, C) * m
        h = linear(copy_to_model(self.ln2(x), self.tp), self.mlp1, self.dtype)
        h = row_linear(F.gelu(h, approximate=self.approximate), self.mlp2, self.dtype,
                       self.tp)
        return x + h * m


class PTv3Encoder(nn.Module):
    """Serialized-attention point U-Net: (B, N, 3), (B, N, C_in) ->
    (B, N, out_dim) float32."""

    def __init__(self, in_dim: int, out_dim: int = 256,
                 enc_channels=(32, 64, 128, 256, 512), enc_depths=(2, 2, 2, 6, 2),
                 enc_heads=(2, 4, 8, 16, 32), dec_channels=(256, 128, 256, 512),
                 dec_depths=(2, 2, 2, 2), dec_heads=(4, 4, 8, 16),
                 patch_size: int = 512, grid_resolution: float = 100.0,
                 dtype: Optional[torch.dtype] = None, gelu_approx: bool = False):
        super().__init__()
        self.enc_channels, self.enc_depths = tuple(enc_channels), tuple(enc_depths)
        self.enc_heads = tuple(enc_heads)
        self.patch_size, self.grid_resolution = patch_size, float(grid_resolution)
        self.dtype = dtype
        S = len(self.enc_channels)
        self.embed = nn.Linear(in_dim, self.enc_channels[0])

        def blocks(prefix, depth, heads, dim):
            for b in range(depth):
                self.add_module(f"{prefix}_b{b}", SerialBlock(
                    dim, heads, patch_size, dtype, gelu_approx))

        for s in range(S):
            if s > 0:
                self.add_module(f"pool{s}_proj", nn.Linear(
                    self.enc_channels[s - 1], self.enc_channels[s]))
            blocks(f"enc{s}", self.enc_depths[s], self.enc_heads[s],
                   self.enc_channels[s])
        self.dec = []
        x_dim = self.enc_channels[-1]
        for d in range(S - 2, -1, -1):
            dim = dec_channels[d] if d < len(dec_channels) else self.enc_channels[d]
            depth = dec_depths[d] if d < len(dec_depths) else 1
            heads = dec_heads[d] if d < len(dec_heads) else 4
            self.add_module(f"dec{d}_proj_up", nn.Linear(x_dim, dim))
            self.add_module(f"dec{d}_proj_skip", nn.Linear(self.enc_channels[d], dim))
            blocks(f"dec{d}", depth, heads, dim)
            self.dec.append((d, depth))
            x_dim = dim
        self.head = nn.Linear(x_dim, out_dim)

    def _run_blocks(self, x, mask, orders, prefix, depth):
        cur_perm = cur_inv = None      # None == storage order
        for b in range(depth):
            perm, inv = orders[ser.ORDERS[b % len(ser.ORDERS)]]
            if cur_perm is None and perm is not None:
                x = take(x, perm)
            elif cur_perm is not None and perm is None:
                x = take(x, cur_inv)
            elif cur_perm is not None and perm is not None:
                x = take(x, torch.gather(cur_inv, 1, perm))
            cur_perm, cur_inv = perm, inv
            x = getattr(self, f"{prefix}_b{b}")(x, mask)
        if cur_perm is not None:
            x = take(x, cur_inv)
        return x

    def forward(self, points: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
        B, N, _ = points.shape
        S = len(self.enc_channels)
        P = self.patch_size
        N_pad = int(math.ceil(N / P) * P)
        pts = F.pad(points, (0, 0, 0, N_pad - N))
        x = F.pad(feats, (0, 0, 0, N_pad - N))
        mask = torch.arange(N_pad, device=points.device) < N
        orders = _orders(pts, mask, self.grid_resolution, ser.ORDERS)
        x = linear(x, self.embed, self.dtype)

        skips = []
        cur_pts, cur_mask = pts, mask
        for s in range(S):
            dim = self.enc_channels[s]
            if s > 0:
                # fixed-window pooling on the z curve (mask is sort-invariant:
                # padding codes sort last and storage is valid-first)
                perm, _ = orders["z"]
                xs, ps = (x, cur_pts) if perm is None else (take(x, perm),
                                                            take(cur_pts, perm))
                n2 = xs.shape[1] // POOL_WINDOW
                xs = linear(xs, getattr(self, f"pool{s}_proj"), self.dtype)
                xw = xs.reshape(B, n2, POOL_WINDOW, dim)
                mw = cur_mask.reshape(n2, POOL_WINDOW)
                xs = torch.where(mw[None, :, :, None], xw,
                                 torch.full((), float("-inf"), dtype=xw.dtype,
                                            device=xw.device)).amax(2)
                xs = torch.where(torch.isfinite(xs), xs, torch.zeros_like(xs))
                pw = ps.reshape(B, n2, POOL_WINDOW, 3)
                cnt = torch.clamp(mw.sum(-1, keepdim=True), min=1)
                cur_pts = (pw * mw[None, :, :, None]).sum(2) / cnt
                cur_mask = mw.any(-1)
                x = xs
                n_next = x.shape[1]
                n_tgt = int(math.ceil(n_next / P) * P) if n_next > P else n_next
                if n_tgt != n_next:
                    extra = n_tgt - n_next
                    x = F.pad(x, (0, 0, 0, extra))
                    cur_pts = F.pad(cur_pts, (0, 0, 0, extra))
                    cur_mask = F.pad(cur_mask, (0, extra))
                # pooled storage is already z-ordered: z is the identity
                orders = {"z": (None, None)}
                orders.update(_orders(cur_pts, cur_mask, self.grid_resolution,
                                      ser.ORDERS[1:]))
            x = self._run_blocks(x, cur_mask, orders, f"enc{s}",
                                 self.enc_depths[s])
            skips.append((x, cur_mask, orders))

        for d, depth in self.dec:
            skip_x, skip_mask, skip_orders = skips[d]
            up = x.repeat_interleave(POOL_WINDOW, dim=1)[:, :skip_x.shape[1]]
            child_inv = skip_orders["z"][1]
            if child_inv is not None:
                up = take(up, child_inv)
            x = (linear(up, getattr(self, f"dec{d}_proj_up"), self.dtype)
                 + linear(skip_x, getattr(self, f"dec{d}_proj_skip"), self.dtype))
            x = self._run_blocks(x, skip_mask, skip_orders, f"dec{d}", depth)
        x = linear(x, self.head, self.dtype)
        return x[:, :N].float()


# ---------------------------------------------------------------------------
# The published form: Pointcept's PT-v3m1 (ptv3_form "pointcept")
# ---------------------------------------------------------------------------

MAX_DEPTH = 10      # bits an axis of the port's int32 curve codes


def _pointcept_ln(dim: int) -> LayerNorm:
    """nn.LayerNorm's eps (1e-5), in fp32."""
    ln = LayerNorm(dim)
    ln.eps = 1e-5
    return ln


class BatchNorm(nn.BatchNorm1d):
    """Pointcept's bn_layer (BatchNorm1d, eps 1e-3, momentum 0.01) over
    rows (R, C), in fp32."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-3, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


class SubMConv(nn.Module):
    """spconv's SubMConv3d: weight (C_out, k, k, k, C_in) (spconv 2.x's
    layout), an optional bias; computed by ops/sparse_conv.subm_conv over
    a level's neighbour map of width k."""

    def __init__(self, c_in: int, c_out: int, k: int, bias: bool,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.k, self.dtype = k, dtype
        self.weight = nn.Parameter(torch.empty(c_out, k, k, k, c_in))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None

    def forward(self, x: torch.Tensor, level: "Level") -> torch.Tensor:
        """x (R, C_in) rows of `level` -> (R, C_out) in the compute dtype."""
        dt = self.dtype or x.dtype
        with profiling.span("refine.subm"):
            y = sc.subm_conv(x.to(dt).contiguous(), level.nbr[self.k],
                             self.weight.to(dt), self.bias)
            return y if level.voxel_of_row is None else y[level.voxel_of_row]


class Level:
    """One level of the point U-Net, in storage order (rows sorted by cloud,
    then by the level's z code; a cloud's rows contiguous):

    rows, cloud (R,), grid (R, 3) int32, coord (R, 3) the rows' mean point,
    codes (4, R) int32 in ORDERS' order, counts (B,) int64 on the device and
    `sizes` on the host; per order the gather (P, K) and scatter (R,)
    indices of its patches of K rows (`patches`); the
    neighbour maps `nbr` {k: (M, k^3) int32} over the level's voxels (M),
    whose outputs reach the rows through `voxel_of_row` (None where each
    row is its own voxel)."""

    def __init__(self, cloud, grid, coord, codes, counts, sizes, depth):
        self.cloud, self.grid, self.coord, self.codes = cloud, grid, coord, codes
        self.counts, self.sizes, self.depth = counts, sizes, depth
        self.rows = int(sum(sizes))
        self.voxel_of_row = None
        self.rep = None
        self.nbr = {}
        self.patches = {}

    def build_patches(self, patch_max: int) -> None:
        """Pointcept's patches (enable_flash off): patch size K = the
        smallest cloud's rows (at most patch_max); each cloud's rows in an
        order's sequence cut into ceil(n / K) patches, the last one its last
        K rows, whose last n mod K rows (all K where it divides) take that
        patch's output."""
        dev = self.cloud.device
        K = min(patch_max, min(self.sizes))
        n = self.counts
        off = torch.cumsum(n, 0) - n
        p = (n + K - 1) // K
        pend = torch.cumsum(p, 0)
        P = sum(-(-s // K) for s in self.sizes)
        ar = torch.arange(P, device=dev)
        pc = torch.searchsorted(pend, ar, right=True)
        j = ar - (pend - p)[pc]
        start = torch.minimum(j * K, n[pc] - K) + off[pc]
        gather = start[:, None] + torch.arange(K, device=dev)[None, :]      # (P, K) positions
        pos = torch.arange(self.rows, device=dev)
        b = self.cloud                                      # a position's cloud: clouds contiguous
        t = pos - off[b]
        jj = torch.minimum(t // K, p[b] - 1)
        slot = (pend - p)[b] * K + jj * K + t - torch.minimum(jj * K, n[b] - K)
        key = (self.cloud.to(torch.int64) << 31)[None] | self.codes.to(torch.int64)
        perm = torch.argsort(key, dim=1, stable=True)
        inv = invert_perm(perm)
        self.patches = {o: (perm[i][gather], slot[inv[i]]) for i, o in enumerate(ser.ORDERS)}

    def build_nbr(self, ks) -> None:
        """The level's neighbour maps for the stencil widths `ks`."""
        with profiling.span("refine.nbr"):
            rep = self.rep if self.rep is not None else torch.arange(
                self.rows, device=self.cloud.device)
            keys = sc.voxel_keys(self.cloud[rep], self.grid[rep])
            self.nbr = {k: sc.neighbour_map(keys, rep, k) for k in ks}


def _runs(cloud: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """(R,) bool: where a run of equal (cloud, code) starts (rows sorted)."""
    first = torch.ones_like(code, dtype=torch.bool)
    first[1:] = (code[1:] != code[:-1]) | (cloud[1:] != cloud[:-1])
    return first


def _first_rows(group: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) the first row of each of the n groups of a nondecreasing (R,)
    group id."""
    return torch.searchsorted(group, torch.arange(n, device=group.device))


def pool_level(level: Level, shift: int, sizes, counts) -> tuple:
    """Pointcept's SerializedPooling of `level` (its rows' clusters: equal
    (cloud, z code >> 3 shift), contiguous in storage): (cluster (R,) int64,
    heads (R', ) first rows, the pooled Level: grid head >> shift, every
    order's code head >> 3 shift, coord the cluster's mean)."""
    z = level.codes[0] >> (3 * shift)
    cluster = torch.cumsum(_runs(level.cloud, z), 0) - 1
    rows = int(sum(sizes))
    head = _first_rows(cluster, rows)
    lengths = torch.diff(head, append=head.new_tensor([level.rows]))
    coord = torch.segment_reduce(level.coord, "mean", lengths=lengths)
    pooled = Level(level.cloud[head], level.grid[head] >> shift, coord,
                   level.codes[:, head] >> (3 * shift), counts, sizes,
                   level.depth - shift)
    return cluster, head, lengths, pooled


class PointceptBlock(nn.Module):
    """PT-v3m1's Block (pre-norm, RPE off, no drop path):
    x + LN(Linear(SubM3(x) + b)), + patch attention of LN1(x), + MLP of
    LN2(x) (hidden 4C)."""

    def __init__(self, dim: int, heads: int, order: str,
                 dtype: Optional[torch.dtype] = None, gelu_approx: bool = False):
        super().__init__()
        self.order, self.dtype = order, dtype
        self.approximate = "tanh" if gelu_approx else "none"
        self.cpe_conv = SubMConv(dim, dim, 3, True, dtype)
        self.cpe_linear = nn.Linear(dim, dim)
        self.cpe_ln = _pointcept_ln(dim)
        self.ln1 = _pointcept_ln(dim)
        self.attn = _PointceptAttention(dim, heads, dtype)
        self.ln2 = _pointcept_ln(dim)
        self.mlp1 = nn.Linear(dim, dim * 4)
        self.mlp2 = nn.Linear(dim * 4, dim)

    def forward(self, x: torch.Tensor, level: Level) -> torch.Tensor:
        C = x.shape[-1]
        c = self.cpe_conv(x, level)
        x = x + self.cpe_ln(linear(c, self.cpe_linear, self.dtype))
        gather, scatter = level.patches[self.order]
        h = self.ln1(x)[gather]                                     # (P, K, C)
        x = x + self.attn(h).reshape(-1, C)[scatter]
        h = linear(self.ln2(x), self.mlp1, self.dtype)
        return x + linear(F.gelu(h, approximate=self.approximate), self.mlp2, self.dtype)


class PointceptUNet(nn.Module):
    """Pointcept's PT-v3m1 U-Net (Wu et al., CVPR 2024; Pointcept
    pointcept/models/point_transformer_v3/point_transformer_v3m1_base.py)
    at the configuration's widths: (B, N, 3), (B, N, C_in) -> (B, N,
    dec_channels[0]) float32, no head.

    Level 0: g = grid_coords(points, res) (each cloud's grid shifted to
    start at 0); depth = the bit length of the largest g of the call; the
    four orders' codes at that depth in one SFC call; the rows sorted
    stably by z code within their cloud (storage order). The level sizes
    follow from the z codes (level l's rows: the distinct z >> 3l of a
    cloud), computed at once and read back in one host sync
    ("ptv3.levels"), the only one of the form. Stem GELU(BN(SubM5(feats))),
    768 -> C0, no bias. Encoder stage s > 0 pools first (SerializedPooling,
    stride 2): clusters the voxels of g >> 1 (z code >> 3), features
    GELU(BN(max over the cluster of Linear(x))), grid the head row's g >> 1,
    every order's code the head's >> 3, coordinates the cluster's mean,
    rows in ascending z code. Decoder stage d unpools (SerializedUnpooling):
    GELU(BN(proj_skip(skip))) + GELU(BN(proj(x)))[cluster of each row].
    Block i of a stage runs order ORDERS[i % 4]. Attention: Pointcept's
    patches (Level.build_patches), scale D^-1/2, softmax in fp32; head width
    64 through kernel A, narrower heads the dense chain. Sparse convs
    through kernel SC (ops/sparse_conv.py) over each level's neighbour
    maps, shared by every block of the level (Pointcept's indice_key).

    Precision as Pointcept's mixed-precision forward runs it (autocast):
    the linears, sparse convs and attention take operands in the compute
    dtype; the norms, GELUs after a norm and the residual stream are fp32.

    Departures (also in the configuration's `assumed`):
      * the orders run in the listed order; Pointcept shuffles them at
        random on every forward (shuffle_orders);
      * a voxel holding several rows is represented by its first row in
        the level's stable z order (spconv keeps an arbitrary one); every
        row of it takes the voxel's conv output, as under spconv;
      * each cloud's grid is shifted to start at 0, and clamped to 10 bits
        an axis (the port's int32 codes); level 0 is sorted stably;
      * the curve codes are the port's SFC codes (x the minor axis of the
        Morton code, "-trans" rotating the axes (1, 2, 0)).
    """

    def __init__(self, in_dim: int, enc_channels=(32, 64, 128, 256, 512),
                 enc_depths=(2, 2, 2, 6, 2), enc_heads=(2, 4, 8, 16, 32),
                 dec_channels=(256, 128, 256, 512), dec_depths=(2, 2, 2, 2),
                 dec_heads=(4, 4, 8, 16), patch_size: int = 512,
                 grid_resolution: float = 100.0, dtype: Optional[torch.dtype] = None,
                 gelu_approx: bool = False):
        super().__init__()
        S = len(enc_channels)
        if len(dec_channels) != S - 1 or len(dec_depths) != S - 1 or len(dec_heads) != S - 1:
            raise ValueError("ptv3_form 'pointcept' needs one decoder stage a level "
                             f"below the last: {S - 1}, got {len(dec_channels)}")
        self.enc_channels, self.enc_depths = tuple(enc_channels), tuple(enc_depths)
        self.dec_depths = tuple(dec_depths)
        self.patch_size, self.grid_resolution = patch_size, float(grid_resolution)
        self.dtype = dtype
        self.approximate = "tanh" if gelu_approx else "none"
        self.stem_conv = SubMConv(in_dim, enc_channels[0], 5, False, dtype)
        self.stem_bn = BatchNorm(enc_channels[0])

        def blocks(prefix, depth, heads, dim):
            for b in range(depth):
                self.add_module(f"{prefix}_b{b}", PointceptBlock(
                    dim, heads, ser.ORDERS[b % len(ser.ORDERS)], dtype, gelu_approx))

        for s in range(S):
            if s > 0:
                self.add_module(f"pool{s}_proj", nn.Linear(enc_channels[s - 1], enc_channels[s]))
                self.add_module(f"pool{s}_bn", BatchNorm(enc_channels[s]))
            blocks(f"enc{s}", enc_depths[s], enc_heads[s], enc_channels[s])
        chans = tuple(dec_channels) + (enc_channels[-1],)
        for d in range(S - 2, -1, -1):
            self.add_module(f"dec{d}_proj_up", nn.Linear(chans[d + 1], chans[d]))
            self.add_module(f"dec{d}_bn_up", BatchNorm(chans[d]))
            self.add_module(f"dec{d}_proj_skip", nn.Linear(enc_channels[d], chans[d]))
            self.add_module(f"dec{d}_bn_skip", BatchNorm(chans[d]))
            blocks(f"dec{d}", dec_depths[d], dec_heads[d], chans[d])

    def _act(self, bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(bn(x), approximate=self.approximate)

    def levels(self, points: torch.Tensor) -> tuple:
        """Level 0 of the clouds (B, N, 3), every level's host sizes and
        device counts from one read-back, and the storage order of level 0
        (perm0 (B, N): storage row b N + i holds point perm0[b, i])."""
        B, N, _ = points.shape
        dev = points.device
        S = len(self.enc_channels)
        pts = points.float().contiguous()
        res = self.grid_resolution
        mask = torch.ones(N, dtype=torch.bool, device=dev)
        grid = ser.grid_coords(pts, res)
        z = ser.sfc_codes(pts, mask, res, ("z",))[0]
        zs, perm0 = torch.sort(z, dim=1, stable=True)
        depth = (grid.amax() >= 2 ** torch.arange(MAX_DEPTH, device=dev)).sum()
        with profiling.span("refine.pool"):
            counts = []
            for lvl in range(S):        # lvl 0: level 0's voxels; lvl >= 1: level lvl's rows
                shift = 3 * torch.minimum(torch.full_like(depth, lvl), depth)
                zl = zs >> shift.to(zs.dtype)
                first = torch.ones_like(zl, dtype=torch.bool)
                first[:, 1:] = zl[:, 1:] != zl[:, :-1]
                counts.append(first.sum(1))
            counts = torch.stack(counts)                                # (S, B)
            stats = torch.cat([depth.reshape(1), counts.flatten()])
            with profiling.host_sync("ptv3.levels"):
                host = stats.tolist()
        depth = int(host[0])
        sizes = [host[1 + lvl * B:1 + (lvl + 1) * B] for lvl in range(S)]
        codes = ser.sfc_codes(pts, mask, res, ser.ORDERS, max(depth, 1))
        rows = torch.arange(B, device=dev)[:, None] * N + perm0          # (B, N) flat points
        flat = rows.reshape(-1)
        cloud = torch.arange(B, device=dev).repeat_interleave(N)
        level0 = Level(cloud, grid.reshape(-1, 3)[flat], pts.reshape(-1, 3)[flat],
                       codes.reshape(len(ser.ORDERS), -1)[:, flat],
                       torch.full((B,), N, dtype=torch.int64, device=dev), [N] * B, depth)
        voxel = torch.cumsum(_runs(cloud, zs.reshape(-1)), 0) - 1
        level0.voxel_of_row = voxel
        level0.rep = _first_rows(voxel, int(sum(sizes[0])))
        return level0, sizes, counts, perm0

    def forward(self, points: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
        B, N, _ = points.shape
        S = len(self.enc_channels)
        level, sizes, counts, perm0 = self.levels(points)
        level.build_patches(self.patch_size)
        level.build_nbr((3, 5))
        x = feats.reshape(B * N, -1)[
            (torch.arange(B, device=feats.device)[:, None] * N + perm0).reshape(-1)]
        x = self._act(self.stem_bn, self.stem_conv(x, level))
        del level.nbr[5]

        skips = []
        for s in range(S):
            if s > 0:
                parent = level
                shift = 1 if parent.depth >= 1 else 0
                with profiling.span("refine.pool"):
                    cluster, head, lengths, level = pool_level(parent, shift, sizes[s], counts[s])
                    proj = linear(x, getattr(self, f"pool{s}_proj"), self.dtype)
                    x = self._act(getattr(self, f"pool{s}_bn"),
                                  torch.segment_reduce(proj, "max", lengths=lengths))
                skips[-1] = skips[-1] + (cluster,)
                level.build_patches(self.patch_size)
                level.build_nbr((3,))
            for b in range(self.enc_depths[s]):
                x = getattr(self, f"enc{s}_b{b}")(x, level)
            skips.append((x, level))

        for d in range(S - 2, -1, -1):
            skip_x, level, cluster = skips[d]
            with profiling.span("refine.pool"):
                up = self._act(getattr(self, f"dec{d}_bn_up"),
                               linear(x, getattr(self, f"dec{d}_proj_up"), self.dtype))
                x = self._act(getattr(self, f"dec{d}_bn_skip"),
                              linear(skip_x, getattr(self, f"dec{d}_proj_skip"),
                                     self.dtype)) + up[cluster]
            for b in range(self.dec_depths[d]):
                x = getattr(self, f"dec{d}_b{b}")(x, level)
        out = torch.empty_like(x)
        out[(torch.arange(B, device=x.device)[:, None] * N + perm0).reshape(-1)] = x
        return out.reshape(B, N, -1)


PTV3_FORMS = ("serial", "pointcept")


class PointRefiner(nn.Module):
    """(B, N, 3) points + (B, N, C) features -> (B, N, out_dim)."""

    def __init__(self, form: str = "serial", **kw):
        super().__init__()
        if form == "serial":
            self.unet = PTv3Encoder(**kw)
        elif form == "pointcept":
            kw.pop("out_dim")
            self.unet = PointceptUNet(**kw)
        else:
            raise ValueError(f"ptv3_form {form!r}: one of {PTV3_FORMS}")

    def forward(self, points: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
        return self.unet(points, feats)


def build_point_refiner(cfg, dtype: Optional[torch.dtype] = None) -> PointRefiner:
    """The refiner of `cfg.ptv3_form`: the serial redesign, or PT-v3m1
    ("pointcept"), whose output is dec0's features (ptv3_output_dim must
    equal ptv3_dec_channels[0])."""
    if cfg.ptv3_form == "pointcept" and cfg.ptv3_output_dim != cfg.ptv3_dec_channels[0]:
        raise ValueError(f"ptv3_form 'pointcept' outputs dec0's {cfg.ptv3_dec_channels[0]} "
                         f"features; ptv3_output_dim is {cfg.ptv3_output_dim}")
    return PointRefiner(
        form=cfg.ptv3_form,
        in_dim=cfg.triplane_feature_dim * 3, out_dim=cfg.ptv3_output_dim,
        enc_channels=tuple(cfg.ptv3_enc_channels),
        enc_depths=tuple(cfg.ptv3_enc_depths),
        enc_heads=tuple(cfg.ptv3_enc_heads),
        dec_channels=tuple(cfg.ptv3_dec_channels),
        dec_depths=tuple(cfg.ptv3_dec_depths),
        dec_heads=tuple(cfg.ptv3_dec_heads),
        patch_size=cfg.ptv3_patch_size,
        grid_resolution=float(cfg.ptv3_grid_resolution),
        dtype=dtype, gelu_approx=bool(cfg.gelu_approx))
