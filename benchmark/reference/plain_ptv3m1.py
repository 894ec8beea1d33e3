"""Pointcept's PT-v3m1 point U-Net in plain PyTorch, float32 with TF32 off:
the reference of the serving refiner's "pointcept" form.

Wu et al., Point Transformer V3 (CVPR 2024, arXiv:2312.10035), as Pointcept
writes it (pointcept/models/point_transformer_v3/point_transformer_v3m1_base.py)
and the talking-avatar upstream vendors it as its gaussian point refiner, at
the widths its `ptv3_encoder.yaml` sets, `enable_flash: false`, RPE off.
Written from those equations alone: it imports no kernel and nothing of
the port. The clouds are rows of one batch with offsets (Pointcept's
`Point`); every step is Pointcept's:

- serialization: g = floor(p * res), shifted per cloud to start at 0;
  depth = the bit length of the largest g; each order's code is
  batch << 3 depth | encode(g, order, depth); the orders argsorted (stably);
- sparse conv (spconv SubMConv3d) per offset over the present pairs only,
  once a voxel (spconv's hash holds one row a voxel): voxel v takes
  W_o x[n(v, o)], n(v, o) the row that represents voxel g_v + o of its
  cloud (a voxel's first row in the level's stable z order), and every row
  of a voxel takes the voxel's output;
- stem GELU(BN(SubM5(feat))), no bias; Block: x + LN(Linear(SubM3(x) + b)),
  x + Attn(LN1(x)), x + fc2(GELU(fc1(LN2(x))));
- attention: patch size K = min(patch, the smallest cloud), Pointcept's
  pad / unpad (the last patch of a cloud is its last K rows), scale
  D^-1/2, softmax in fp32; head width 64 through the reference's blocked
  attention (logged as "attention");
- SerializedPooling (stride 2): clusters by torch.unique of the z code
  >> 3, features GELU(BN(max of Linear(x))), coordinates the mean, grid
  the head's g >> 1, codes the head's >> 3; SerializedUnpooling:
  GELU(BN(proj_skip(skip))) + GELU(BN(proj(x)))[cluster].

Departures from Pointcept (as in the configuration's `assumed`): the
orders run in the listed order, not shuffled; the grid is shifted per
cloud and kept to 10 bits an axis; argsorts are stable.

The module names and parameter shapes are the port's (models/ptv3.py's
PointceptUNet under `unet`), so one state_dict loads both.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F
from torch import nn

from .plain_avatar.device import fp32_geometry
from .plain_avatar.ops import serialization as ser
from .plain_avatar.ops.attention import KERNEL_HEAD_DIM, attention_plain
from .plain_avatar.ops.calls import logged

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")


@logged("subm_conv")
def subm_conv(x: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor, bias, pairs: int):
    """Submanifold conv over voxels: x (R, C_in) rows, nbr (M, k^3) rows of
    x (-1 absent), weight (C_out, k, k, k, C_in) -> (M, C_out); `pairs` the
    present (voxel, offset) pairs, what the products cost."""
    C_out, C_in = weight.shape[0], weight.shape[-1]
    w = weight.reshape(C_out, -1, C_in)
    y = x.new_zeros(x.shape[0], C_out)
    for o in range(nbr.shape[1]):
        rows = (nbr[:, o] >= 0).nonzero()[:, 0]
        if rows.numel():
            y.index_add_(0, rows, x[nbr[rows, o]] @ w[:, o].t())
    return y if bias is None else y + bias


def neighbours(batch: torch.Tensor, grid: torch.Tensor, order_z: torch.Tensor, k: int,
               depth: int) -> tuple:
    """(nbr (M, k^3), voxel (R,)): for each of the level's M voxels and
    offset o, the representative row (first in the stable z order) of voxel
    g + o of its cloud, -1 where none; and each row's voxel."""
    side = (1 << max(depth, 1)) + 4

    def key(b, g):
        g = g + 2
        return ((b * side + g[:, 0]) * side + g[:, 1]) * side + g[:, 2]

    keys = key(batch, grid)
    uniq, inv = torch.unique(keys, return_inverse=True)
    rank = torch.empty_like(order_z)
    rank[order_z] = torch.arange(order_z.numel(), device=order_z.device)
    first = torch.full((uniq.numel(),), order_z.numel(), dtype=torch.int64, device=keys.device)
    first = first.scatter_reduce(0, inv, rank, "amin")
    rep = order_z[first]                                         # the voxel's representative row
    r = k // 2
    out = []
    for o in itertools.product(range(-r, r + 1), repeat=3):
        q = key(batch[rep], grid[rep] + torch.tensor(o, device=grid.device))
        pos = torch.searchsorted(uniq, q).clamp(max=uniq.numel() - 1)
        out.append(torch.where(uniq[pos] == q, rep[pos], -1))
    return torch.stack(out, 1), inv


class PlainSubMConv(nn.Module):
    def __init__(self, c_in, c_out, k, bias):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, k, k, k, c_in))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None

    def forward(self, x, nbr, voxel=None):
        """x (R, C_in), nbr (M, k^3) over the voxels, voxel (R,) each row's
        voxel (None: a row a voxel) -> (R, C_out)."""
        y = subm_conv(x, nbr, self.weight, self.bias, int((nbr >= 0).sum()))
        return y if voxel is None else y[voxel]


def bn(dim):
    return nn.BatchNorm1d(dim, eps=1e-3, momentum=0.01)


class PlainAttention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.query, self.key, self.value = nn.Linear(dim, dim), nn.Linear(dim, dim), nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x, point, order_index):
        K = point["patch"]
        pad, unpad = point["pad"], point["unpad"]
        order = point["order"][order_index][pad]
        inverse = unpad[point["inverse"][order_index]]
        H, C = self.heads, x.shape[1]
        D = C // H

        def heads(t):
            return t[order].reshape(-1, K, H, D).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        if D == KERNEL_HEAD_DIM:
            out = attention_plain(q, k, v, D ** -0.5)
        else:
            attn = torch.softmax((q.float() * D ** -0.5) @ k.float().transpose(-2, -1), -1)
            out = attn.to(v.dtype) @ v
        feat = out.transpose(1, 2).reshape(-1, C)[inverse]
        return self.out(feat)


class PlainBlock(nn.Module):
    def __init__(self, dim, heads, order_index, approximate):
        super().__init__()
        self.order_index, self.approximate = order_index, approximate
        self.cpe_conv = PlainSubMConv(dim, dim, 3, True)
        self.cpe_linear = nn.Linear(dim, dim)
        self.cpe_ln = nn.LayerNorm(dim)
        self.ln1 = nn.LayerNorm(dim)
        self.attn = PlainAttention(dim, heads)
        self.ln2 = nn.LayerNorm(dim)
        self.mlp1 = nn.Linear(dim, 4 * dim)
        self.mlp2 = nn.Linear(4 * dim, dim)

    def forward(self, x, point):
        x = x + self.cpe_ln(self.cpe_linear(self.cpe_conv(x, *point["nbr3"])))
        x = x + self.attn(self.ln1(x), point, self.order_index)
        return x + self.mlp2(F.gelu(self.mlp1(self.ln2(x)), approximate=self.approximate))


def padding_and_inverse(offset: torch.Tensor, K: int):
    """Pointcept's SerializedAttention.get_padding_and_inverse."""
    bincount = torch.diff(offset, prepend=offset.new_zeros(1))
    bincount_pad = torch.div(bincount + K - 1, K, rounding_mode="trunc") * K
    mask_pad = bincount > K
    bincount_pad = ~mask_pad * bincount + mask_pad * bincount_pad
    _offset = F.pad(offset, (1, 0))
    _offset_pad = F.pad(torch.cumsum(bincount_pad, dim=0), (1, 0))
    pad = torch.arange(int(_offset_pad[-1]), device=offset.device)
    unpad = torch.arange(int(_offset[-1]), device=offset.device)
    for i in range(len(offset)):
        o0, o1, p0, p1 = (int(_offset[i]), int(_offset[i + 1]), int(_offset_pad[i]),
                          int(_offset_pad[i + 1]))
        n, n_pad = int(bincount[i]), int(bincount_pad[i])
        unpad[o0:o1] += p0 - o0
        if n != n_pad:
            pad[p1 - K + n % K:p1] = pad[p1 - 2 * K + n % K:p1 - K].clone()
        pad[p0:p1] -= p0 - o0
    return pad, unpad


class PlainPTv3m1(nn.Module):
    """PT-v3m1 at the given widths: forward(points (B, N, 3), feats (B, N,
    C_in)) -> (B, N, dec_channels[0]) float32."""

    def __init__(self, in_dim, enc_channels, enc_depths, enc_heads, dec_channels,
                 dec_depths, dec_heads, patch_size, grid_resolution, gelu_approx):
        super().__init__()
        self.S = S = len(enc_channels)
        self.enc_depths, self.dec_depths = tuple(enc_depths), tuple(dec_depths)
        self.patch_size, self.res = patch_size, float(grid_resolution)
        self.approximate = "tanh" if gelu_approx else "none"
        self.stem_conv = PlainSubMConv(in_dim, enc_channels[0], 5, False)
        self.stem_bn = bn(enc_channels[0])
        for s in range(S):
            if s > 0:
                self.add_module(f"pool{s}_proj", nn.Linear(enc_channels[s - 1], enc_channels[s]))
                self.add_module(f"pool{s}_bn", bn(enc_channels[s]))
            for b in range(enc_depths[s]):
                self.add_module(f"enc{s}_b{b}", PlainBlock(enc_channels[s], enc_heads[s], b % 4,
                                                           self.approximate))
        chans = tuple(dec_channels) + (enc_channels[-1],)
        for d in range(S - 2, -1, -1):
            self.add_module(f"dec{d}_proj_up", nn.Linear(chans[d + 1], chans[d]))
            self.add_module(f"dec{d}_bn_up", bn(chans[d]))
            self.add_module(f"dec{d}_proj_skip", nn.Linear(enc_channels[d], chans[d]))
            self.add_module(f"dec{d}_bn_skip", bn(chans[d]))
            for b in range(dec_depths[d]):
                self.add_module(f"dec{d}_b{b}", PlainBlock(chans[d], dec_heads[d], b % 4,
                                                           self.approximate))

    def act(self, norm, x):
        return F.gelu(norm(x), approximate=self.approximate)

    def attach(self, point):
        """The level's orders, patches and 3^3 neighbours."""
        code = point["code"]
        order = torch.argsort(code, dim=1, stable=True)
        inverse = torch.zeros_like(order).scatter_(
            1, order, torch.arange(code.shape[1], device=code.device).repeat(code.shape[0], 1))
        point["order"], point["inverse"] = order, inverse
        counts = torch.diff(point["offset"], prepend=point["offset"].new_zeros(1))
        point["patch"] = K = min(int(counts.min()), self.patch_size)
        point["pad"], point["unpad"] = padding_and_inverse(point["offset"], K)
        point["nbr3"] = neighbours(point["batch"], point["grid"], order[0], 3, point["depth"])
        return point

    def pool(self, point, s, x):
        pooling_depth = 1 if point["depth"] >= 1 else 0
        code = point["code"] >> (pooling_depth * 3)
        _, cluster, counts = torch.unique(code[0], sorted=True, return_inverse=True,
                                          return_counts=True)
        _, indices = torch.sort(cluster, stable=True)
        idx_ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, dim=0)])
        head = indices[idx_ptr[:-1]]
        n = head.numel()
        proj = getattr(self, f"pool{s}_proj")(x)
        feat = proj.new_empty(n, proj.shape[1]).scatter_reduce(
            0, cluster[:, None].expand_as(proj), proj, "amax", include_self=False)
        coord = point["coord"].new_zeros(n, 3).index_add_(0, cluster, point["coord"])
        batch = point["batch"][head]
        pooled = {"code": code[:, head], "coord": coord / counts[:, None],
                  "grid": point["grid"][head] >> pooling_depth, "batch": batch,
                  "depth": point["depth"] - pooling_depth,
                  "offset": torch.cumsum(torch.bincount(batch, minlength=int(point["offset"].numel())), 0)}
        return self.act(getattr(self, f"pool{s}_bn"), feat), self.attach(pooled), cluster

    @torch.no_grad()
    def forward(self, points: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
        with fp32_geometry():
            B, N, _ = points.shape
            dev = points.device
            grid = torch.cat([ser.grid_coords(points[b].float(), self.res) for b in range(B)])
            grid = grid.to(torch.int64)
            batch = torch.arange(B, device=dev).repeat_interleave(N)
            depth = int(grid.max()).bit_length()
            code = torch.stack([(batch << (3 * depth)) | ser.encode(grid, o, max(depth, 1)).to(torch.int64)
                                for o in ORDERS])
            point = self.attach({"code": code, "coord": points.reshape(-1, 3).float(),
                                 "grid": grid, "batch": batch, "depth": depth,
                                 "offset": torch.arange(1, B + 1, device=dev) * N})
            nbr5 = neighbours(batch, grid, point["order"][0], 5, depth)
            x = self.act(self.stem_bn, self.stem_conv(feats.reshape(B * N, -1).float(), *nbr5))
            skips = []
            for s in range(self.S):
                if s > 0:
                    x, point, cluster = self.pool(point, s, x)
                    skips[-1] = skips[-1] + (cluster,)
                for b in range(self.enc_depths[s]):
                    x = getattr(self, f"enc{s}_b{b}")(x, point)
                skips.append((x, point))
            for d in range(self.S - 2, -1, -1):
                skip, point, cluster = skips[d]
                up = self.act(getattr(self, f"dec{d}_bn_up"), getattr(self, f"dec{d}_proj_up")(x))
                x = self.act(getattr(self, f"dec{d}_bn_skip"),
                             getattr(self, f"dec{d}_proj_skip")(skip)) + up[cluster]
                for b in range(self.dec_depths[d]):
                    x = getattr(self, f"dec{d}_b{b}")(x, point)
            return x.reshape(B, N, -1)


class PlainRefiner(nn.Module):
    """The renderer's `point_refiner`: the U-Net under `unet`, as the port's."""

    def __init__(self, cfg):
        super().__init__()
        self.unet = PlainPTv3m1(
            cfg.triplane_feature_dim * 3, cfg.ptv3_enc_channels, cfg.ptv3_enc_depths,
            cfg.ptv3_enc_heads, cfg.ptv3_dec_channels, cfg.ptv3_dec_depths, cfg.ptv3_dec_heads,
            cfg.ptv3_patch_size, cfg.ptv3_grid_resolution, cfg.gelu_approx)

    def forward(self, points, feats):
        return self.unet(points, feats)
