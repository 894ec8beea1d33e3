"""Submanifold sparse 3-D convolution (spconv's SubMConv3d) over the voxels
of a point level, and the neighbour maps it reads.

A level's rows carry integer grid coordinates and a cloud id. Several rows
may share a voxel (at PTv3's first level); the voxel's representative is
its first row in the level's storage order, and every row of the voxel
takes the voxel's output, as under spconv, whose hash keeps one row of a
voxel. For output voxel v and offset o (a (k, k, k) stencil, offsets
-(k//2) .. k//2 an axis):

    y_v = b + sum_o W[:, o, :] x[n(v, o)]

where n(v, o) is the representative row of voxel g_v + o of the same cloud,
and an absent voxel adds nothing. `W` is kept in spconv 2.x's layout
(C_out, k, k, k, C_in), the stencil's axes in the grid's axis order (x, y,
z): the same cross-correlation as F.conv3d over a dense grid whose weight is
W.permute(0, 4, 1, 2, 3).

`neighbour_map` builds n(v, o) as an (M, k^3) int32 array of row indices
(-1 where absent) with library calls: one key per voxel (cloud and the
three coordinates, each shifted by 2 into a 12-bit field, so that a
neighbour's key is the voxel's key plus a constant of the offset), one sort
of the level's keys and one `torch.searchsorted` for every (voxel, offset).

`subm_conv` runs kernel SC (`csrc/subm_conv.cu`) on bf16 CUDA tensors,
under autograd too (`SubmConv`: the input's gradient is kernel SC again,
over the mirrored map; the weight's a gather and a matmul per offset), and
the plain version (`subm_conv_plain`: a gather and a matmul per offset over
the present pairs, fp32 sums) on the CPU.
"""

from __future__ import annotations

import itertools
from typing import Optional

import torch

from .. import kernels

FIELD_BITS = 12                 # bits a coordinate field of a voxel key
FIELD_SHIFT = 2                 # coordinates shifted by 2: offsets -2..2 stay in the field


def stencil(k: int) -> torch.Tensor:
    """(k^3, 3) int64 offsets of a k-wide stencil, the last axis fastest
    (the order of the weight's (k, k, k) axes)."""
    r = k // 2
    return torch.tensor(list(itertools.product(range(-r, r + 1), repeat=3)),
                        dtype=torch.int64)


def voxel_keys(cloud: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """(M,) int64 keys of voxels: cloud (M,) and grid (M, 3) coordinates in
    [0, 1024)."""
    g = grid.to(torch.int64) + FIELD_SHIFT
    return ((cloud.to(torch.int64) << (3 * FIELD_BITS)) | (g[:, 0] << (2 * FIELD_BITS))
            | (g[:, 1] << FIELD_BITS) | g[:, 2])


def offset_keys(k: int, device) -> torch.Tensor:
    """(k^3,) int64: what each offset of the stencil adds to a voxel key."""
    o = stencil(k)
    return ((o[:, 0] << (2 * FIELD_BITS)) + (o[:, 1] << FIELD_BITS) + o[:, 2]).to(device)


def neighbour_map(keys: torch.Tensor, rows: torch.Tensor, k: int) -> torch.Tensor:
    """(M, k^3) int32: for each voxel (its key in `keys`, its representative
    row in `rows`) and each offset, the representative row of the
    neighbouring voxel, -1 where the level has none. Keys are distinct."""
    skeys, order = torch.sort(keys)
    srows = rows[order]
    q = keys[:, None] + offset_keys(k, keys.device)[None, :]
    pos = torch.searchsorted(skeys, q).clamp_(max=skeys.numel() - 1)
    found = skeys[pos] == q
    return torch.where(found, srows[pos], -1).to(torch.int32)


def subm_conv_plain(x: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of kernel SC: x (R, C_in), nbr (M, K) int row indices
    (-1 absent), weight (C_out, k, k, k, C_in), bias (C_out,) or None ->
    (M, C_out) in x.dtype. Per offset, the present pairs' rows gathered and
    multiplied by that offset's matrix, the products summed in float32 (in
    float64 for float64 inputs) in offset order."""
    dt = torch.promote_types(x.dtype, torch.float32)
    C_out, C_in = weight.shape[0], weight.shape[-1]
    w = weight.reshape(C_out, -1, C_in).to(x.dtype)
    M, K = nbr.shape
    y = torch.zeros(M, C_out, dtype=dt, device=x.device)
    for o in range(K):
        idx = nbr[:, o].long()
        present = (idx >= 0).nonzero().squeeze(1)
        if present.numel():
            part = x[idx[present]] @ w[:, o].t()
            y = y.index_add(0, present, part.to(dt))
    if bias is not None:
        y = y + bias.to(dt)
    return y.to(x.dtype)


def excess_error(out: torch.Tensor, ref: torch.Tensor) -> float:
    """How far kernel SC's bf16 output is from the plain version's float64
    sums on the same bf16 inputs, as the worst ratio of |out - ref| to its
    tolerance: one bf16 spacing of the value (2^-7 |ref|; rounding the
    output costs at most half of it) plus 2^-12 of ref's RMS (fp32 sums in
    another order, each of up to 125 x 768 products, and cancellation).
    1 or less agrees."""
    ref = ref.double()
    diff = (out.double() - ref).abs()
    rms = float(ref.pow(2).mean().sqrt())
    tol = 2.0 ** -7 * ref.abs() + 2.0 ** -12 * rms + torch.finfo(torch.float32).tiny
    return float((diff / tol).max())


def subm_conv(x: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel SC on CUDA tensors (through `SubmConv`, so a gradient flows),
    the plain version on the CPU: x (R, C_in) bf16, nbr (M, K) int32,
    weight (C_out, k, k, k, C_in), bias (C_out,) or None -> (M, C_out) bf16
    (fp32 sums)."""
    if x.device.type == "cpu":
        return subm_conv_plain(x, nbr, weight, bias)
    w = weight.reshape(weight.shape[0], -1, weight.shape[-1]).to(torch.bfloat16)
    return SubmConv.apply(x, nbr, w, None if bias is None else bias.float())


def _launch(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor]) -> torch.Tensor:
    """One launch of kernel SC: x (R, C_in), nbr (M, K), w (C_out, K,
    C_in), b (C_out,) fp32 or None -> (M, C_out) bf16. On the CPU (the
    tests of `SubmConv`'s backward) the plain version in its place."""
    if x.device.type == "cpu":
        return subm_conv_plain(x, nbr, w[:, :, None, None, :], b)
    w, b = w.contiguous(), None if b is None else b.contiguous()
    _check_kernel_args(x, nbr, w, b)
    M, C_out = nbr.shape[0], w.shape[0]
    y = torch.empty(M, C_out, dtype=torch.bfloat16, device=x.device)
    lib = kernels.library("subm_conv")
    rc = lib.subm_conv_launch(x.data_ptr(), nbr.data_ptr(), w.data_ptr(),
                              0 if b is None else b.data_ptr(), y.data_ptr(),
                              M, nbr.shape[1], x.shape[1], C_out, kernels.stream_ptr(x.device))
    kernels.check(rc, "subm_conv")
    subm_conv.launches += 1
    return y


def mirrored_map(nbr: torch.Tensor, rows: int) -> torch.Tensor:
    """The transposed map of a submanifold conv: (M, K) int32 voxel indices
    (-1 absent), entry (u, o) the voxel at g_u - o, for a map `nbr` (M, K)
    of representative rows among `rows`. The stencil is symmetric, so
    offset o's mirror is K - 1 - o, and a voxel's own row is its centre
    entry (K // 2)."""
    M, K = nbr.shape
    rep = nbr[:, K // 2].long()
    voxel = torch.full((rows,), -1, dtype=torch.int32, device=nbr.device)
    voxel[rep] = torch.arange(M, dtype=torch.int32, device=nbr.device)
    return torch.where(nbr >= 0, voxel[nbr.long().clamp(min=0)], -1).flip(1).contiguous()


class SubmConv(torch.autograd.Function):
    """Kernel SC under autograd: forward y = SC(x, nbr, w) + b over the
    voxels. Backward, for y_v = sum_o W_o x[n(v, o)]:

      dx[rep(u)] = sum_o W_o^T dy[u - o]   (kernel SC over `mirrored_map`
                                            with the weight transposed to
                                            (C_in, K, C_out)); rows that
                                            represent no voxel get 0;
      dW_o = dy^T x[n(., o)]               (a gather and an fp32 matmul per
                                            offset, absent pairs zeroed; no
                                            host sync);
      db = sum_v dy_v (in fp32 at least)."""

    @staticmethod
    def forward(ctx, x, nbr, w, b):
        ctx.save_for_backward(x, nbr, w)
        ctx.has_bias = b is not None
        return _launch(x, nbr, w, b)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, nbr, w = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        acc = torch.promote_types(x.dtype, torch.float32)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            rep = nbr[:, nbr.shape[1] // 2].long()
            dx = x.new_zeros(x.shape).index_copy_(
                0, rep, _launch(dy, mirrored_map(nbr, x.shape[0]), w.permute(2, 1, 0), None))
        if ctx.needs_input_grad[2]:
            dw = torch.empty_like(w)
            dyt = dy.t().to(acc)
            for o in range(nbr.shape[1]):
                idx = nbr[:, o].long()
                xg = x[idx.clamp(min=0)].to(acc) * (idx >= 0)[:, None]
                dw[:, o] = dyt @ xg
        if ctx.has_bias and ctx.needs_input_grad[3]:
            db = dy.sum(0, dtype=acc)
        return dx, None, dw, db


subm_conv.launches = 0


def _check_kernel_args(x, nbr, w, b) -> None:
    """Kernel SC's checks: bf16 contiguous rows, an int32 map, widths that
    are multiples of 32 (the kernel's 32-channel steps and column tiles)."""
    if x.device.type != "cuda":
        raise ValueError(f"subm_conv: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"subm_conv: x must be a contiguous (R, C) bf16 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if nbr.dtype != torch.int32 or nbr.dim() != 2 or not nbr.is_contiguous() \
            or nbr.device != x.device:
        raise ValueError(f"subm_conv: nbr must be a contiguous (M, K) int32 tensor on "
                         f"{x.device}, got {tuple(nbr.shape)} {nbr.dtype}")
    C_out, K, C_in = w.shape
    if K != nbr.shape[1] or C_in != x.shape[1]:
        raise ValueError(f"subm_conv: weight {tuple(w.shape)} does not fit x "
                         f"{tuple(x.shape)} and nbr {tuple(nbr.shape)}")
    if C_in % 32 or C_out % 32:
        raise ValueError(f"subm_conv: widths must be multiples of 32, got C_in {C_in}, "
                         f"C_out {C_out}")
    if b is not None and (b.shape != (C_out,) or b.device != x.device):
        raise ValueError(f"subm_conv: bias must be ({C_out},) on {x.device}")
