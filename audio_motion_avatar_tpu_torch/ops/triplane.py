"""Triplane token layout, quad-row layout (kernel Q) and sparse sampling.

Plane/axis conventions: plane 0 "xy" <- point coords (x, y); plane 1 "xz";
plane 2 "yz". The first coordinate indexes plane width (columns), the
second height (rows), as F.grid_sample's grid[..., 0] / grid[..., 1];
sampling is bilinear with align_corners=False and zero padding.

The sparse samplers read the final upsample level's covered tiles. The
serving one goes through a QUAD layout: row (s, y, x) holds the full 2x2
bilinear footprint [t(y,x) | t(y,x+1) | t(y+1,x) | t(y+1,x+1)] with
cross-tile taps from the right / bottom / diagonal neighbour tiles, so each
point reads one 4C row. The 4-tap form gathers the four texels one by one,
the slab form one 2x2 slab of a tile with a 1 px halo (`tile_halo`). All
three are gathers: plain torch indexing, except the quad build (kernel Q).
Training differentiates the quad build through `QuadRowsFunction`: kernel
Q forward, kernel Q-bwd (csrc/quad_rows_bwd.cu, `quad_rows_bwd`) for the
tiles' gradient, the exact transpose of the quad layout summed in a fixed
order (`quad_rows_bwd_plain`); the row gather's backward is autograd's.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels

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


def neighbor_table(slot: torch.Tensor, grid: int, cap: int) -> torch.Tensor:
    """`neighbor_slots` as one contiguous (FP, cap, 3) int32 table (right,
    bottom, diagonal), the layout kernel Q reads."""
    return torch.stack(neighbor_slots(slot, grid, cap), -1).to(torch.int32).contiguous()


def incoming_slots(nbr: torch.Tensor, cap: int):
    """Invert the neighbour table nbr (FP, cap, 3) (`neighbor_table`): the
    sources of target slot u in direction d (0 right, 1 bottom, 2 diagonal),
    the slots s with nbr[f, s, d] == u, are src[f, d, start[f, d, u]:
    start[f, d, u + 1]] in ascending slot order. Returns (src (FP, 3, cap),
    start (FP, 3, cap + 1)), both int32, built on nbr's device without a
    host sync (a stable sort of the targets; the counts in integers).

    Not one-to-one: a slot no tile maps to takes tile 0 as its tile (the
    argmax of an all-false row), so every unused slot has tile 0's
    neighbours and the slots of tiles 1, grid and grid + 1 collect them."""
    FP = nbr.shape[0]
    tgt = nbr.permute(0, 2, 1).long()                            # (FP, 3, cap)
    src = torch.argsort(tgt, dim=-1, stable=True)
    counts = torch.zeros(FP, 3, cap + 1, dtype=torch.long, device=nbr.device)
    counts.scatter_add_(2, tgt, torch.ones_like(tgt))
    start = torch.cat([torch.zeros_like(counts[..., :1]), counts.cumsum(-1)[..., :cap]], -1)
    return src.to(torch.int32).contiguous(), start.to(torch.int32).contiguous()


def quad_rows(tiles: torch.Tensor, slot: torch.Tensor, grid: int,
              nbr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel Q on CUDA tensors, its plain version on CPU tensors.
    tiles (FP, cap, T, T, C) + slot (FP, G*G) -> (FP, cap, T, T, 4C),
    bit-identical either way. nbr: `neighbor_table(slot, grid, cap)` where
    the caller has it."""
    if tiles.device.type == "cpu":
        return quad_rows_plain(tiles, slot, grid)
    _check_quad_args("quad_rows", tiles, slot, grid, 1)
    FP, cap, T, _, C = tiles.shape
    if nbr is None:
        nbr = neighbor_table(slot, grid, cap)
    out = torch.empty(FP, cap, T, T, 4 * C, dtype=tiles.dtype, device=tiles.device)
    lib = kernels.library("quad_rows")
    rc = lib.quad_rows_launch(tiles.data_ptr(), nbr.data_ptr(), out.data_ptr(),
                              FP, cap, T, C * tiles.element_size() // 16,
                              kernels.stream_ptr(tiles.device))
    kernels.check(rc, "quad_rows")
    quad_rows.launches += 1
    return out


quad_rows.launches = 0


def _check_quad_args(name: str, x: torch.Tensor, slot: torch.Tensor, grid: int,
                     taps: int) -> None:
    """The checks of kernels Q / Q-bwd on a CUDA tensor x (FP, cap, T, T,
    taps * C): contiguous, square tiles, a texel of whole 16-byte vectors,
    slot (FP, G*G) on x's device."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 5 or x.shape[2] != x.shape[3] or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous (FP, cap, T, T, C) tensor, "
                         f"got {tuple(x.shape)}")
    texel_bytes = x.shape[4] // taps * x.element_size()
    if x.shape[4] % taps or texel_bytes % 16:
        raise ValueError(f"{name}: a texel ({texel_bytes} B) must be a multiple of 16 bytes")
    FP = x.shape[0]
    if slot.shape != (FP, grid * grid) or slot.device != x.device:
        raise ValueError(f"{name}: slot must be ({FP}, {grid * grid}) on {x.device}, "
                         f"got {tuple(slot.shape)}")


def quad_rows_bwd_plain(dquad: torch.Tensor, slot: torch.Tensor, grid: int,
                        incoming=None) -> torch.Tensor:
    """Plain version of kernel Q-bwd, the exact transpose of
    `quad_rows_plain`: dquad (FP, cap, T, T, 4C) -> dtiles (FP, cap, T, T,
    C). With q_k tap k's C channels and R(u), B(u), D(u) the slots whose
    right, bottom, diagonal neighbour is u (`incoming_slots`, or
    `incoming` given), dt_u[y, x] = ((t1 + t2) + t3) + t4:
      t1 = q_u[y, x, 0];
      t2 = q_u[y, x-1, 1] (x >= 1), else S_R(q_s[y, T-1, 1]);
      t3 = q_u[y-1, x, 2] (y >= 1), else S_B(q_s[T-1, x, 2]);
      t4 = q_u[y-1, x-1, 3] (y, x >= 1); S_R(q_s[y-1, T-1, 3]) (x = 0);
           S_B(q_s[T-1, x-1, 3]) (y = 0); S_D(q_s[T-1, T-1, 3]) (both 0);
    each S a sum from 0 over its sources in ascending slot order. All in
    float32 (float64 for float64 dquad), rounded once to dquad's dtype: the
    same bits on every device, and kernel Q-bwd's."""
    FP, cap, T, _, C4 = dquad.shape
    C = C4 // 4
    if incoming is None:
        incoming = incoming_slots(neighbor_table(slot, grid, cap), cap)
    src, start = (x.long() for x in incoming)
    q = dquad.to(torch.promote_types(dquad.dtype, torch.float32))
    q0, q1, q2, q3 = (q[..., k * C:(k + 1) * C] for k in range(4))
    f = torch.arange(FP, device=dquad.device)[:, None]

    def incoming_sum(d, strip):
        """S_d of (FP, cap, L, C) source strips -> (FP, cap, L, C)."""
        lo, hi = start[:, d, :cap], start[:, d, 1:]
        acc = torch.zeros_like(strip)
        for k in range(int((hi - lo).max())):
            ok = (lo + k < hi)[..., None, None]
            s = torch.gather(src[:, d], 1, torch.clamp(lo + k, max=cap - 1))
            acc = torch.where(ok, acc + strip[f, s], acc)
        return acc

    r = incoming_sum(0, torch.cat([q1[:, :, :, T - 1], q3[:, :, :T - 1, T - 1]], 2))
    b = incoming_sum(1, torch.cat([q2[:, :, T - 1], q3[:, :, T - 1, :T - 1]], 2))
    d = incoming_sum(2, q3[:, :, T - 1, T - 1][:, :, None])
    t2 = torch.cat([r[:, :, :T, None], q1[:, :, :, :T - 1]], 3)
    t3 = torch.cat([b[:, :, None, :T], q2[:, :, :T - 1]], 2)
    t4 = torch.cat([torch.cat([d, b[:, :, T:]], 2)[:, :, None],
                    torch.cat([r[:, :, T:, None], q3[:, :, :T - 1, :T - 1]], 3)], 2)
    return (((q0 + t2) + t3) + t4).to(dquad.dtype)


def quad_rows_bwd(dquad: torch.Tensor, slot: torch.Tensor, grid: int,
                  incoming=None) -> torch.Tensor:
    """Kernel Q-bwd on CUDA tensors, its plain version on CPU tensors:
    dquad (FP, cap, T, T, 4C) + slot (FP, G*G) -> dtiles (FP, cap, T, T,
    C), bit-identical either way and from launch to launch (no atomics).
    incoming: `incoming_slots` of the slot map where the caller has it."""
    if dquad.device.type == "cpu":
        return quad_rows_bwd_plain(dquad, slot, grid, incoming)
    _check_quad_args("quad_rows_bwd", dquad, slot, grid, 4)
    if dquad.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quad_rows_bwd: bfloat16 or float32, got {dquad.dtype}")
    FP, cap, T, _, C4 = dquad.shape
    if incoming is None:
        incoming = incoming_slots(neighbor_table(slot, grid, cap), cap)
    src, start = incoming
    out = torch.empty(FP, cap, T, T, C4 // 4, dtype=dquad.dtype, device=dquad.device)
    lib = kernels.library("quad_rows_bwd")
    rc = lib.quad_rows_bwd_launch(dquad.data_ptr(), src.data_ptr(), start.data_ptr(),
                                  out.data_ptr(), FP, cap, T,
                                  C4 // 4 * dquad.element_size() // 16,
                                  int(dquad.dtype == torch.bfloat16),
                                  kernels.stream_ptr(dquad.device))
    kernels.check(rc, "quad_rows_bwd")
    quad_rows_bwd.launches += 1
    return out


quad_rows_bwd.launches = 0


class QuadRowsFunction(torch.autograd.Function):
    """The quad-row build under autograd: kernel Q forward, kernel Q-bwd
    backward (the plain versions on CPU tensors). Keeps the integer
    incoming tables and the slot map for the backward, never the tiles."""

    @staticmethod
    def forward(ctx, tiles, slot, grid):
        cap = tiles.shape[1]
        nbr = neighbor_table(slot, grid, cap)
        ctx.grid = grid
        ctx.save_for_backward(slot, *incoming_slots(nbr, cap))
        return quad_rows(tiles, slot, grid, nbr)

    @staticmethod
    def backward(ctx, dquad):
        slot, src, start = ctx.saved_tensors
        return quad_rows_bwd(dquad.contiguous(), slot, ctx.grid, (src, start)), None, None


def build_quad(tiles: torch.Tensor, slot: torch.Tensor,
               grid: int) -> torch.Tensor:
    """(B, 3, cap, T, T, C) tiles + (B, 3, G*G) slot -> (B, 3, cap, T, T,
    4C) quad rows, one kernel launch for every frame and plane; through
    `QuadRowsFunction` where the tiles need a gradient."""
    B, Pn = tiles.shape[:2]
    flat = tiles.reshape((B * Pn,) + tiles.shape[2:]).contiguous()
    s = slot.reshape(B * Pn, -1)
    if torch.is_grad_enabled() and tiles.requires_grad:
        q = QuadRowsFunction.apply(flat, s, grid)
    else:
        q = quad_rows(flat, s, grid)
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


def grid_sample_2d_sparse(tiles: torch.Tensor, slot: torch.Tensor,
                          grid_xy: torch.Tensor, grid: int, tile_px: int,
                          res: int) -> torch.Tensor:
    """The 4-tap sparse sampler: `grid_sample_2d_nhwc`'s math on the
    covered tiles (Bq, cap, T, T, C) of a res^2 plane, slot (Bq, G*G) tile
    -> slot (-1 holes); grid_xy (Bq, N, 2) -> (Bq, N, C) float32. A tap
    whose texel lies in an uncovered tile reads 0."""
    Bq, cap, T, _, C = tiles.shape
    rows = tiles.reshape(Bq, cap * T * T, C)
    x = (grid_xy[..., 0] + 1.0) * (res * 0.5) - 0.5
    y = (grid_xy[..., 1] + 1.0) * (res * 0.5) - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    x0i, y0i = x0.long(), y0.long()
    b = torch.arange(Bq, device=tiles.device)[:, None]
    slot = slot.long()

    def tap(xi, yi, w):
        inb = (xi >= 0) & (xi < res) & (yi >= 0) & (yi < res)
        xc, yc = torch.clamp(xi, 0, res - 1), torch.clamp(yi, 0, res - 1)
        s = torch.gather(slot, 1, (yc // tile_px) * grid + xc // tile_px)
        ok = inb & (s >= 0)
        idx = torch.clamp(s, min=0) * (T * T) + (yc % tile_px) * T + xc % tile_px
        return rows[b, idx].float() * (w * ok)[..., None]

    return (tap(x0i, y0i, wx0 * wy0) + tap(x0i + 1, y0i, wx1 * wy0)
            + tap(x0i, y0i + 1, wx0 * wy1) + tap(x0i + 1, y0i + 1, wx1 * wy1))


def sample_triplane_sparse(sp, points: torch.Tensor, radius: float) -> torch.Tensor:
    """The 4-tap sparse sampling of SparseTriplanes `sp`: (B, N, 3) world
    points -> (B, N, 3C) float32 ordered [xy, xz, yz]."""
    B = points.shape[0]
    return concat_planes(grid_sample_2d_sparse(
        sp.tiles.reshape((B * 3,) + sp.tiles.shape[2:]),
        sp.slot.reshape(B * 3, -1), plane_grids(points, radius),
        sp.grid, sp.tile_px, sp.res))


def tile_halo(tiles: torch.Tensor, slot: torch.Tensor, grid: int) -> torch.Tensor:
    """Sparse tiles with a +1 px bottom / right halo from their covered
    neighbours: (FP, cap, T, T, C) + slot (FP, G*G) -> (FP, cap, T+1, T+1,
    C). Column T of tile (r, c) is column 0 of tile (r, c+1), row T row 0
    of tile (r+1, c), the corner texel 0 of (r+1, c+1); a neighbour that
    is uncovered or off the grid reads 0. With the halo, every bilinear
    2x2 footprint whose top-left texel lies in a tile is one slab of it."""
    FP, cap, T, _, C = tiles.shape
    nr, nb, nd = neighbor_slots(slot, grid, cap)
    ext = torch.cat([tiles, tiles.new_zeros(FP, 1, T, T, C)], 1)  # cap = zero slot
    f = torch.arange(FP, device=tiles.device)[:, None]
    right = ext[:, :, :, 0, :][f, nr]                           # (FP, cap, T, C)
    bottom = ext[:, :, 0, :, :][f, nb]                          # (FP, cap, T, C)
    corner = ext[:, :, 0, 0, :][f, nd]                          # (FP, cap, C)
    top = torch.cat([tiles, right[:, :, :, None]], 3)           # (FP, cap, T, T+1, C)
    bot = torch.cat([bottom, corner[:, :, None]], 2)            # (FP, cap, T+1, C)
    return torch.cat([top, bot[:, :, None]], 2)


def grid_sample_2d_sparse_slab(tiles_h: torch.Tensor, slot: torch.Tensor,
                               grid_xy: torch.Tensor, grid: int, tile_px: int,
                               res: int) -> torch.Tensor:
    """The slab sparse sampler: each point's four taps read as one 2x2
    slab of its top-left texel's haloed tile (`tile_halo`, (Bq, cap, T+1,
    T+1, C)); slot (Bq, G*G), grid_xy (Bq, N, 2) -> (Bq, N, C) float32.
    Equal to the 4-tap sampler (up to reassociation) except where the
    top-left texel's tile is uncovered and a neighbour tap's is not: the
    slab then reads 0 for all four."""
    Bq, cap, T1, _, C = tiles_h.shape
    x = (grid_xy[..., 0] + 1.0) * (res * 0.5) - 0.5
    y = (grid_xy[..., 1] + 1.0) * (res * 0.5) - 0.5
    sx, ax0, ax1 = _lane_weights(x, res)
    sy, ay0, ay1 = _lane_weights(y, res)
    sl = torch.gather(slot.long(), 1, (sy // tile_px) * grid + (sx // tile_px))
    ok = (sl >= 0).float()
    i00 = (torch.clamp(sl, min=0) * T1 + sy % tile_px) * T1 + sx % tile_px
    idx = torch.stack([i00, i00 + 1, i00 + T1, i00 + T1 + 1], -1)   # (Bq, N, 4)
    rows = tiles_h.reshape(Bq, cap * T1 * T1, C)
    v = rows[torch.arange(Bq, device=tiles_h.device)[:, None, None], idx].float()
    bx0, bx1 = (ax0 * ok)[..., None], (ax1 * ok)[..., None]
    return (ay0[..., None] * (bx0 * v[..., 0, :] + bx1 * v[..., 1, :])
            + ay1[..., None] * (bx0 * v[..., 2, :] + bx1 * v[..., 3, :]))


def sample_triplane_sparse_slab(sp, tiles_h: torch.Tensor, points: torch.Tensor,
                                radius: float) -> torch.Tensor:
    """The slab sparse sampling of SparseTriplanes `sp` from its haloed
    tiles (B, 3, cap, T+1, T+1, C) (built once, shared by both sampling
    passes): (B, N, 3) -> (B, N, 3C) float32 ordered [xy, xz, yz]."""
    B = points.shape[0]
    return concat_planes(grid_sample_2d_sparse_slab(
        tiles_h.reshape((B * 3,) + tiles_h.shape[2:]),
        sp.slot.reshape(B * 3, -1), plane_grids(points, radius),
        sp.grid, sp.tile_px, sp.res))
