"""Triplane token layout, quad-row layout (kernel Q) and sparse sampling.

Plane/axis conventions: plane 0 "xy" <- point coords (x, y); plane 1 "xz";
plane 2 "yz". The first coordinate indexes plane width (columns), the
second height (rows), as F.grid_sample's grid[..., 0] / grid[..., 1];
sampling is bilinear with align_corners=False and zero padding.

The sparse samplers read the final upsample level's covered tiles. The
serving one goes through a QUAD layout: row (s, y, x) holds the full 2x2
bilinear footprint [t(y,x) | t(y,x+1) | t(y+1,x) | t(y+1,x+1)] with
cross-tile taps from the right / bottom / diagonal neighbour tiles, so each
point reads one 4C row; the rows are built by slices and concatenations
(`quad_rows_plain`, where the port launches kernel Q) and read by plain
torch indexing.
"""

from __future__ import annotations

import torch

from .calls import logged


PLANE_AXES = ((0, 1), (0, 2), (1, 2))


def tokens_to_planes(tokens: torch.Tensor, resolution: int) -> torch.Tensor:
    """(..., C, 3*R*R) channel-first tokens -> (..., 3, C, R, R)."""
    *lead, C, S = tokens.shape
    if S != 3 * resolution * resolution:
        raise ValueError(f"tokens length {S} != 3 * {resolution}^2")
    x = tokens.reshape(*lead, C, 3, resolution, resolution)
    return x.movedim(-4, -3)


def planes_to_tokens(planes: torch.Tensor) -> torch.Tensor:
    """(..., 3, C, R, R) -> (..., C, 3*R*R)."""
    *lead, P, C, H, W = planes.shape
    return planes.movedim(-4, -3).reshape(*lead, C, P * H * W)


def plane_cell_index(points: torch.Tensor, radius: float,
                     resolution: int) -> torch.Tensor:
    """(..., N, 3) world points -> (..., 3, N) cell ids col + R*row in
    [0, R^2) of the encoder's [0, 1]-normalised planes."""
    p = torch.clamp(points, -radius + 1e-6, radius - 1e-6)
    u = (p + radius) / (2.0 * radius)
    idx = []
    for a0, a1 in PLANE_AXES:
        c0 = torch.floor(u[..., a0] * resolution).long()
        c1 = torch.floor(u[..., a1] * resolution).long()
        idx.append(torch.clamp(c0 + resolution * c1, 0, resolution * resolution - 1))
    return torch.stack(idx, -2)


def _segment_max_gather(values: torch.Tensor, index: torch.Tensor,
                        size: int) -> torch.Tensor:
    """(B, N, C), (B, N) -> (B, N, C): every point gets the max over its
    cell; an empty cell reads 0."""
    B, N, C = values.shape
    idx = index[..., None].expand(B, N, C)
    seg = values.new_zeros(B, size, C).scatter_reduce(
        1, idx, values, "amax", include_self=False)
    return torch.gather(seg, 1, idx)


def pool_local_max(values: torch.Tensor, cell_index: torch.Tensor,
                   resolution: int) -> torch.Tensor:
    """Local max-pool summed over the three planes: values (B, N, C),
    cell_index (B, 3, N) -> (B, N, C)."""
    size = resolution * resolution
    return sum(_segment_max_gather(values, cell_index[:, p], size) for p in range(3))


def scatter_mean_plane(values: torch.Tensor, cell_index: torch.Tensor,
                       resolution: int) -> torch.Tensor:
    """Mean of the point features in each cell: values (B, N, C),
    cell_index (B, N) -> (B, C, R, R); empty cells are 0.

    Each cell's sum runs in point order, in the values' dtype: the cell ids
    sorted stably, then one sequential reduction a segment. That is the
    order of the JAX package's segment_sum on the CPU, and the same on
    every run and device (an atomic scatter-add of floats sums in whatever
    order its threads arrive). The points a cell are counted in integers
    (exact in any order, and without a host sync), then capped as the JAX
    package's sum of ones in the values' dtype is: a sequential float sum
    of ones stops at 2 / eps (256 in bf16)."""
    B, N, C = values.shape
    size = resolution * resolution
    key = (cell_index + size * torch.arange(B, device=values.device)[:, None]).reshape(-1)
    order = torch.argsort(key, stable=True)
    lengths = torch.zeros(B * size, dtype=torch.long, device=values.device).scatter_add_(
        0, key, torch.ones_like(key))
    s = torch.segment_reduce(values.reshape(B * N, C)[order], "sum", lengths=lengths,
                             unsafe=True)
    cap = int(2 / torch.finfo(values.dtype).eps)
    cnt = lengths.clamp(max=cap).to(values.dtype)[:, None]
    mean = s / torch.clamp(cnt, min=1.0)
    return mean.reshape(B, resolution, resolution, C).permute(0, 3, 1, 2)


def grid_sample_2d_nhwc(feat: torch.Tensor, grid_xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of channel-last planes (align_corners=False, zero
    padding): feat (Bq, H, W, C), grid_xy (Bq, N, 2) in [-1, 1] -> (Bq, N,
    C) float32. Taps gather in the planes' dtype, weights and sums fp32."""
    Bq, H, W, C = feat.shape
    rows = feat.reshape(Bq, H * W, C)
    x = (grid_xy[..., 0] + 1.0) * (W * 0.5) - 0.5
    y = (grid_xy[..., 1] + 1.0) * (H * 0.5) - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    x0i, y0i = x0.long(), y0.long()
    b = torch.arange(Bq, device=feat.device)[:, None]

    def tap(xi, yi, w):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)
        return rows[b, idx].float() * (w * inb)[..., None]

    return (tap(x0i, y0i, wx0 * wy0) + tap(x0i + 1, y0i, wx1 * wy0)
            + tap(x0i, y0i + 1, wx0 * wy1) + tap(x0i + 1, y0i + 1, wx1 * wy1))


def plane_grids(points: torch.Tensor, radius: float) -> torch.Tensor:
    """(B, N, 3) world points -> (3B, N, 2) grid_sample coordinates in [-1,
    1], plane-major within each batch entry."""
    B, N, _ = points.shape
    u = torch.clamp(points / radius, -1.0, 1.0)
    g = torch.stack([torch.stack([u[..., a0], u[..., a1]], -1)
                     for a0, a1 in PLANE_AXES], 1)               # (B, 3, N, 2)
    return g.reshape(B * 3, N, 2)


def concat_planes(feats: torch.Tensor) -> torch.Tensor:
    """(3B, N, C) per-plane features -> (B, N, 3C) ordered [xy, xz, yz]."""
    P, N, C = feats.shape
    B = P // 3
    return feats.reshape(B, 3, N, C).permute(0, 2, 1, 3).reshape(B, N, 3 * C)


def sample_triplane_nhwc(planes: torch.Tensor, points: torch.Tensor,
                         radius: float) -> torch.Tensor:
    """Dense triplane sampling: planes (B, 3, H, W, C) channel-last, points
    (B, N, 3) world -> (B, N, 3C) float32 ordered [xy, xz, yz]."""
    B = points.shape[0]
    return concat_planes(grid_sample_2d_nhwc(
        planes.reshape((B * 3,) + planes.shape[2:]), plane_grids(points, radius)))


def neighbor_slots(slot: torch.Tensor, grid: int, cap: int):
    """Right / bottom / diagonal neighbour SLOT of every slot, missing or
    uncovered neighbours mapped to `cap`. slot: (FP, G*G) tile -> slot (-1
    holes). A slot's tile is the FIRST tile mapped to it (0 if none), as
    jnp.argmax gives. Returns three (FP, cap) int64 tensors."""
    G2 = grid * grid
    match = slot[:, None, :] == torch.arange(cap, device=slot.device)[None, :, None]
    tid = torch.argmax(match.to(torch.int32), dim=2)            # (FP, cap)
    r, c = tid // grid, tid % grid

    def n(dr, dc):
        ok = (r + dr < grid) & (c + dc < grid)
        nt = torch.clamp(tid + dr * grid + dc, 0, G2 - 1)
        ns = torch.where(ok, torch.gather(slot.long(), 1, nt),
                         torch.full_like(nt, -1))
        return torch.where(ns >= 0, ns, torch.full_like(ns, cap))

    return n(0, 1), n(1, 0), n(1, 1)


@logged("quad_rows")
def quad_rows_plain(tiles: torch.Tensor, slot: torch.Tensor,
                    grid: int) -> torch.Tensor:
    """Plain version of kernel Q: (FP, cap, T, T, C) + (FP, G*G) ->
    (FP, cap, T, T, 4C) by slices and concatenations."""
    FP, cap, T, _, C = tiles.shape
    nr, nb, nd = neighbor_slots(slot, grid, cap)
    zero = tiles.new_zeros(FP, 1, T, T, C)
    ext = torch.cat([tiles, zero], 1)                           # cap = zero slot
    f = torch.arange(FP, device=tiles.device)[:, None]
    right = ext[:, :, :, 0, :][f, nr]                           # (FP, cap, T, C)
    bottom = ext[:, :, 0, :, :][f, nb]                          # (FP, cap, T, C)
    corner = ext[:, :, 0, 0, :][f, nd]                          # (FP, cap, C)
    tap1 = torch.cat([tiles[:, :, :, 1:], right[:, :, :, None]], 3)
    tap2 = torch.cat([tiles[:, :, 1:], bottom[:, :, None]], 2)
    t3_top = torch.cat([tiles[:, :, 1:, 1:], right[:, :, 1:, None]], 3)
    t3_last = torch.cat([bottom[:, :, 1:], corner[:, :, None]], 2)
    tap3 = torch.cat([t3_top, t3_last[:, :, None]], 2)
    return torch.cat([tiles, tap1, tap2, tap3], -1)


def build_quad(tiles: torch.Tensor, slot: torch.Tensor,
               grid: int) -> torch.Tensor:
    """(B, 3, cap, T, T, C) tiles + (B, 3, G*G) slot -> (B, 3, cap, T, T,
    4C) quad rows, one build for every frame and plane."""
    B, Pn = tiles.shape[:2]
    flat = tiles.reshape((B * Pn,) + tiles.shape[2:]).contiguous()
    s = slot.reshape(B * Pn, -1)
    q = quad_rows_plain(flat, s, grid)
    return q.reshape((B, Pn) + q.shape[1:])


def _lane_weights(x: torch.Tensor, res: int):
    """Slab start s = clip(floor(x), 0, res-2) and the weights of texels s
    and s+1 reproducing the zero-padded 2-tap lerp of floor(x), floor(x)+1."""
    x0 = torch.floor(x)
    w1 = x - x0
    w0 = 1.0 - w1
    x0i = x0.long()
    s = torch.clamp(x0i, 0, res - 2)
    w0m = w0 * ((x0i >= 0) & (x0i < res))
    w1m = w1 * ((x0i + 1 >= 0) & (x0i + 1 < res))
    d = x0i - s
    zero = torch.zeros_like(w0)
    a0 = torch.where(d == 0, w0m, torch.where(d == -1, w1m, zero))
    a1 = torch.where(d == 0, w1m, torch.where(d == 1, w0m, zero))
    return s, a0, a1


def slot_rank(sorted_ids: torch.Tensor, tid: torch.Tensor):
    """Slot of tile `tid` = its rank among the ascending covered ids.
    sorted_ids (Bq, cap) ascending (sentinel-padded), tid (Bq, N) ->
    (slot (Bq, N), present (Bq, N) bool)."""
    lt = torch.searchsorted(sorted_ids, tid, side="left")
    le = torch.searchsorted(sorted_ids, tid, side="right")
    return lt, le > lt


def grid_sample_2d_sparse_quad(quad: torch.Tensor, sorted_ids: torch.Tensor,
                               grid_xy: torch.Tensor, grid: int, tile_px: int,
                               res: int) -> torch.Tensor:
    """One quad-row gather per point. quad (Bq, cap, T, T, 4C), sorted_ids
    (Bq, cap), grid_xy (Bq, N, 2) in [-1, 1] -> (Bq, N, C) float32. A point
    whose top-left texel's tile is not covered reads 0."""
    Bq, cap, T, _, C4 = quad.shape
    C = C4 // 4
    rows = quad.reshape(Bq, cap * T * T, C4)
    x = (grid_xy[..., 0] + 1.0) * (res * 0.5) - 0.5
    y = (grid_xy[..., 1] + 1.0) * (res * 0.5) - 0.5
    sx, ax0, ax1 = _lane_weights(x, res)
    sy, ay0, ay1 = _lane_weights(y, res)
    tid = (sy // tile_px) * grid + (sx // tile_px)
    sl, present = slot_rank(sorted_ids.long(), tid)
    ok = present.float()
    sc = torch.clamp(sl, 0, cap - 1)
    idx = sc * (T * T) + (sy % tile_px) * T + (sx % tile_px)
    v = rows[torch.arange(Bq, device=quad.device)[:, None], idx]   # (Bq, N, 4C)
    w00 = (ay0 * ax0 * ok)[..., None]
    w01 = (ay0 * ax1 * ok)[..., None]
    w10 = (ay1 * ax0 * ok)[..., None]
    w11 = (ay1 * ax1 * ok)[..., None]

    def tap(i):
        return v[..., i * C:(i + 1) * C].float()

    return w00 * tap(0) + w01 * tap(1) + w10 * tap(2) + w11 * tap(3)


def sample_triplane_sparse_quad(sp, quad: torch.Tensor, points: torch.Tensor,
                                radius: float) -> torch.Tensor:
    """(B, N, 3) world points -> (B, N, 3C) float32 features ordered
    [xy, xz, yz], from SparseTriplanes `sp` and its quad rows (B, 3, cap,
    T, T, 4C) (built once, shared by both sampling passes)."""
    B = points.shape[0]
    return concat_planes(grid_sample_2d_sparse_quad(
        quad.reshape((B * 3,) + quad.shape[2:]),
        sp.sorted_ids.reshape(B * 3, -1), plane_grids(points, radius),
        sp.grid, sp.tile_px, sp.res))
