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
from ..ops.attention import KERNEL_HEAD_DIM, dense_attention
from ..parallel.tensor import ModelAxis, copy_to_model
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

    def forward(self, hq: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
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
            out = dense_attention(q / torch.tensor(math.sqrt(D), dtype=q.dtype),
                                  k, v, 1.0, mask)
        return row_linear(merge_heads(out), self.out, self.dtype, self.tp)


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


class PointRefiner(nn.Module):
    """(B, N, 3) points + (B, N, C) features -> (B, N, out_dim)."""

    def __init__(self, **kw):
        super().__init__()
        self.unet = PTv3Encoder(**kw)

    def forward(self, points: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
        return self.unet(points, feats)


def build_point_refiner(cfg, dtype: Optional[torch.dtype] = None) -> PointRefiner:
    return PointRefiner(
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
