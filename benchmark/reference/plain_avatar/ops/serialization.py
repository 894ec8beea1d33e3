"""Space-filling-curve serialization of point clouds (int32 bit ops).

z-order (Morton) codes by bit interleaving and Hilbert codes by the
Skilling transform, 10 bits per axis (30-bit codes fit int32); "-trans"
orders permute the axes (1, 2, 0) before encoding.
"""

from __future__ import annotations

import torch

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")
_TRANS = (1, 2, 0)


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
        grid = grid[..., list(_TRANS)]
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
