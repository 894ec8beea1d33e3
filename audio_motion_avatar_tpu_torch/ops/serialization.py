"""Space-filling-curve serialization of point clouds (int32 bit ops).

z-order (Morton) codes by bit interleaving and Hilbert codes by the
Skilling transform, at most 10 bits per axis (30-bit codes fit int32);
"-trans" orders permute the axes (1, 2, 0) before encoding. `depth` is the
bits an axis (10 unless asked): Morton codes do not depend on it, Hilbert
codes do (PTv3-m1 encodes at the bit length of the batch's largest grid
coordinate).

`sfc_codes` gives one PTv3 level's codes in every order asked for: kernel
SFC (`csrc/sfc_codes.cu`, two launches) on CUDA tensors, its plain version
`sfc_codes_plain` (the chain below, op by op) on CPU tensors, bit-identical.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import kernels

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")
PAD_CODE = 2 ** 30      # the code of a masked point: sorts after every real code


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def z_encode(grid: torch.Tensor, depth: int = 10) -> torch.Tensor:
    """(..., 3) non-negative int32 -> (...,) Morton code, x minor."""
    x = _part1by2(grid[..., 0].to(torch.int32))
    y = _part1by2(grid[..., 1].to(torch.int32))
    z = _part1by2(grid[..., 2].to(torch.int32))
    return x | (y << 1) | (z << 2)


def hilbert_encode(grid: torch.Tensor, depth: int = 10) -> torch.Tensor:
    """Hilbert index via the Skilling Gray-code transform."""
    n = 3
    x = [grid[..., i].to(torch.int32) for i in range(n)]
    m = 1 << (depth - 1)
    q = m
    while q > 1:
        p = q - 1
        for i in range(n):
            bit_set = (x[i] & q) != 0
            if i == 0:
                x[0] = torch.where(bit_set, x[0] ^ p, x[0])
            else:
                t = (x[0] ^ x[i]) & p
                x[0], x[i] = (torch.where(bit_set, x[0] ^ p, x[0] ^ t),
                              torch.where(bit_set, x[i], x[i] ^ t))
        q >>= 1
    for i in range(1, n):
        x[i] = x[i] ^ x[i - 1]
    t = torch.zeros_like(x[0])
    q = m
    while q > 1:
        t = torch.where((x[n - 1] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    for i in range(n):
        x[i] = x[i] ^ t
    code = torch.zeros_like(x[0])
    for b in range(depth - 1, -1, -1):
        for i in range(n):
            code = (code << 1) | ((x[i] >> b) & 1)
    return code


def encode(grid: torch.Tensor, order: str = "z", depth: int = 10) -> torch.Tensor:
    if order.endswith("-trans"):
        grid = torch.roll(grid, -1, dims=-1)                 # axes (1, 2, 0)
        order = order[: -len("-trans")]
    if order == "z":
        return z_encode(grid, depth)
    if order == "hilbert":
        return hilbert_encode(grid, depth)
    raise ValueError(order)


def grid_coords(points: torch.Tensor, grid_resolution: float,
                depth: int = 10) -> torch.Tensor:
    """(B, N, 3) float -> (B, N, 3) int32 grid coords, shifted to start at 0
    per cloud and clipped to the curve's bit depth."""
    g = torch.floor(points * grid_resolution).to(torch.int32)
    g = g - g.amin(dim=-2, keepdim=True)
    return torch.clamp(g, 0, (1 << depth) - 1)


def sfc_codes_plain(points: torch.Tensor, mask: torch.Tensor, grid_resolution: float,
                    orders: Sequence[str], depth: int = 10) -> torch.Tensor:
    """Plain version of kernel SFC: points (B, N, 3), mask (N,) bool valid
    -> (K, B, N) int32 `depth`-bit-an-axis codes of the K `orders`
    (PAD_CODE where masked), the grid's minimum taken over every row of a
    cloud, masked ones included, the grid clamped to `depth` bits."""
    grid = grid_coords(points, grid_resolution, depth)
    pad = torch.full((), PAD_CODE, dtype=torch.int32, device=points.device)
    return torch.stack([torch.where(mask, encode(grid, o, depth), pad) for o in orders])


def sfc_codes(points: torch.Tensor, mask: torch.Tensor, grid_resolution: float,
              orders: Sequence[str], depth: int = 10) -> torch.Tensor:
    """Kernel SFC on CUDA tensors, its plain version on CPU tensors: points
    (B, N, 3) float32, mask (N,) bool -> (K, B, N) int32 codes at `depth`
    bits an axis (1 to 10), the same bits either way."""
    if not 1 <= depth <= 10:
        raise ValueError(f"sfc_codes: depth must be 1 to 10 bits an axis, got {depth}")
    if points.device.type == "cpu":
        return sfc_codes_plain(points, mask, grid_resolution, orders, depth)
    _check_codes_args(points, mask, orders)
    B, N, _ = points.shape
    K = len(orders)
    ids = 0
    for k, o in enumerate(orders):
        ids |= ORDERS.index(o) << (2 * k)
    # the codes and, after them, the min pass's (B, 3) scratch: one allocation
    buf = torch.empty(K * B * N + 3 * B, dtype=torch.int32, device=points.device)
    out = buf[:K * B * N].view(K, B, N)
    lib = kernels.library("sfc_codes")
    rc = lib.sfc_codes_launch(points.data_ptr(), mask.data_ptr(),
                              buf.data_ptr() + 4 * K * B * N, out.data_ptr(),
                              B, N, float(grid_resolution), K, ids, int(depth),
                              kernels.stream_ptr(points.device))
    kernels.check(rc, "sfc_codes")
    sfc_codes.launches += 1
    return out


sfc_codes.launches = 0


def _check_codes_args(points: torch.Tensor, mask: torch.Tensor,
                      orders: Sequence[str]) -> None:
    """Kernel SFC's checks on a CUDA points tensor."""
    if points.device.type != "cuda":
        raise ValueError(f"sfc_codes: unsupported device {points.device}")
    if points.dtype != torch.float32:
        raise ValueError(f"sfc_codes: points must be float32, got {points.dtype}")
    if points.dim() != 3 or points.shape[2] != 3 or not points.is_contiguous():
        raise ValueError(f"sfc_codes: expected contiguous (B, N, 3) points, "
                         f"got {tuple(points.shape)}")
    N = points.shape[1]
    if (mask.dtype != torch.bool or mask.shape != (N,) or not mask.is_contiguous()
            or mask.device != points.device):
        raise ValueError(f"sfc_codes: mask must be a contiguous ({N},) bool tensor on "
                         f"{points.device}, got {tuple(mask.shape)} {mask.dtype}")
    if not 1 <= len(orders) <= len(ORDERS) or any(o not in ORDERS for o in orders):
        raise ValueError(f"sfc_codes: orders must be 1 to 4 of {ORDERS}, got {orders}")
