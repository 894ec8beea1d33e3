"""3D Gaussian splatting: activations, EWA projection and the naive oracle.

The math reproduces the 3DGS pipeline of the CUDA rasterizer the reference
calls (perspective-Jacobian 2D covariance with +0.3 px dilation, conic
evaluation, front-to-back compositing with the 1/255 alpha floor, 0.99
alpha ceiling and 1e-4 transmittance cutoff, white background). The serving
renderer composites through ops/splat_segmented.py. All geometry is fp32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import fp32_geometry
from .cameras import Camera

SCALE_BIAS = 3.9
OPACITY_BIAS = 0.0
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
NEAR_CULL = 0.2
TILE = 16
COV_DILATION = 0.3


class Projected(NamedTuple):
    mean2d: torch.Tensor   # (..., N, 2) pixel coords
    conic: torch.Tensor    # (..., N, 3) inverse 2D covariance (cxx, cxy, cyy)
    depth: torch.Tensor    # (..., N) camera-space z
    radius: torch.Tensor   # (..., N) screen-space extent (pixels)
    opacity: torch.Tensor  # (..., N)
    color: torch.Tensor    # (..., N, 3)
    valid: torch.Tensor    # (..., N) bool


def activate_scales(raw_scales: torch.Tensor) -> torch.Tensor:
    """scale = min(exp(s - 3.9), 0.1)."""
    return torch.clamp(torch.exp(raw_scales - SCALE_BIAS), max=0.1)


def activate_opacity(raw_opacity: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(raw_opacity - OPACITY_BIAS)


def view_colors(colors: torch.Tensor) -> torch.Tensor:
    """The colours a view splats: RGB clipped to [0, 1]."""
    return torch.clamp(colors, 0.0, 1.0)


def _quat_rot_rows(quats: torch.Tensor):
    q = quats / torch.linalg.norm(quats, dim=-1, keepdim=True).clamp_min(1e-8)
    w, x, y, z = q.unbind(-1)
    return (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y))


@fp32_geometry()
def project_gaussians(means3d: torch.Tensor, quats: torch.Tensor,
                      scales_act: torch.Tensor, opacity_act: torch.Tensor,
                      colors: torch.Tensor, cam: Camera) -> Projected:
    """EWA projection of (..., N) gaussians through cameras with the same
    leading dims (cam.view (..., 4, 4)); elementwise, no tiny matmuls."""
    W, H = cam.width, cam.height
    view = cam.view[..., None, :, :]                      # (..., 1, 4, 4)
    mx, my, mz = means3d.unbind(-1)
    t = [view[..., i, 0] * mx + view[..., i, 1] * my + view[..., i, 2] * mz
         + view[..., i, 3] for i in range(3)]
    tz = t[2]
    tan_x = cam.tan_fovx[..., None]
    tan_y = cam.tan_fovy[..., None]
    fx = W / (2.0 * tan_x)
    fy = H / (2.0 * tan_y)
    limx = 1.3 * tan_x
    limy = 1.3 * tan_y
    tz_safe = torch.where(tz.abs() < 1e-6, torch.full_like(tz, 1e-6), tz)
    txz = torch.maximum(torch.minimum(t[0] / tz_safe, limx), -limx)
    tyz = torch.maximum(torch.minimum(t[1] / tz_safe, limy), -limy)
    tx = txz * tz_safe
    ty = tyz * tz_safe

    inv_z = 1.0 / tz_safe
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z * inv_z
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z * inv_z
    ma = [j00 * view[..., 0, c] + j02 * view[..., 2, c] for c in range(3)]
    mb = [j11 * view[..., 1, c] + j12 * view[..., 2, c] for c in range(3)]

    r = _quat_rot_rows(quats)
    sc = scales_act.unbind(-1)
    pa, pb = [], []
    for j in range(3):
        pa.append((ma[0] * r[j] + ma[1] * r[3 + j] + ma[2] * r[6 + j]) * sc[j])
        pb.append((mb[0] * r[j] + mb[1] * r[3 + j] + mb[2] * r[6 + j]) * sc[j])
    cxx = pa[0] * pa[0] + pa[1] * pa[1] + pa[2] * pa[2] + COV_DILATION
    cyy = pb[0] * pb[0] + pb[1] * pb[1] + pb[2] * pb[2] + COV_DILATION
    cxy = pa[0] * pb[0] + pa[1] * pb[1] + pa[2] * pb[2]

    det = cxx * cyy - cxy * cxy
    det_safe = torch.where(det <= 0, torch.ones_like(det), det)
    conic = torch.stack([cyy / det_safe, -cxy / det_safe, cxx / det_safe], -1)
    mid = 0.5 * (cxx + cyy)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))

    full = (cam.proj @ cam.view)[..., None, :, :]
    px_clip = full[..., 0, 0] * mx + full[..., 0, 1] * my + full[..., 0, 2] * mz + full[..., 0, 3]
    py_clip = full[..., 1, 0] * mx + full[..., 1, 1] * my + full[..., 1, 2] * mz + full[..., 1, 3]
    pw = full[..., 3, 0] * mx + full[..., 3, 1] * my + full[..., 3, 2] * mz + full[..., 3, 3]
    pw_safe = torch.where(pw.abs() < 1e-7, torch.full_like(pw, 1e-7), pw)
    mean2d = torch.stack([(px_clip / pw_safe + 1.0) * W * 0.5 - 0.5,
                          (py_clip / pw_safe + 1.0) * H * 0.5 - 0.5], -1)
    valid = (tz > NEAR_CULL) & (det > 0)
    return Projected(mean2d=mean2d, conic=conic, depth=tz, radius=radius,
                     opacity=opacity_act, color=colors, valid=valid)


def bin_gaussians_sorted(proj: Projected, width: int, height: int,
                         max_per_tile: int, max_window: int = 8):
    """Sort-based tile binning of ONE view (proj fields (N, ...)): every
    depth-ordered gaussian emits the max_window^2 tile window at its bbox
    corner (pairs outside the bbox masked); the (tile, depth rank) pairs
    are sorted once and each tile keeps its first K = min(max_per_tile, N).

    Returns (order (N,) depth argsort, tile_idx (T, K) indices into the
    depth-ordered arrays, tile_mask (T, K) bool). The key is the JAX
    package's: (tile << rank_bits) | rank, dead pairs on a sentinel tile,
    one stable sort (int64 here, so the packed and the two-key forms are
    the same sort; the sentinel follows the form the JAX package picks)."""
    tx, ty = width // TILE, height // TILE
    n_tiles = tx * ty
    n = proj.mean2d.shape[0]
    K = min(max_per_tile, n)
    W2 = max_window * max_window
    dev = proj.mean2d.device

    order = torch.argsort(proj.depth, stable=True)
    mean2d = proj.mean2d[order]
    radius = torch.where(proj.valid[order], proj.radius[order],
                         torch.zeros_like(proj.radius[order]))
    x0r = torch.floor((mean2d[:, 0] - radius) / TILE)
    x1r = torch.floor((mean2d[:, 0] + radius) / TILE)
    y0r = torch.floor((mean2d[:, 1] - radius) / TILE)
    y1r = torch.floor((mean2d[:, 1] + radius) / TILE)
    alive = (radius > 0) & (x1r >= 0) & (x0r <= tx - 1) & (y1r >= 0) & \
        (y0r <= ty - 1)
    x0 = x0r.clamp(0, tx - 1).long()
    x1 = x1r.clamp(0, tx - 1).long()
    y0 = y0r.clamp(0, ty - 1).long()
    y1 = y1r.clamp(0, ty - 1).long()
    off = torch.arange(max_window, device=dev)
    gx = x0[:, None] + off
    gy = y0[:, None] + off
    vx = (gx <= x1[:, None]) & (gx < tx)
    vy = (gy <= y1[:, None]) & (gy < ty)
    tile_id = gy[:, :, None] * tx + gx[:, None, :]                 # (N, W, W)
    valid = vy[:, :, None] & vx[:, None, :] & alive[:, None, None]

    rank = torch.arange(n, device=dev)[:, None, None]
    rank_bits = max(1, (n - 1).bit_length())
    packed = (n_tiles + 1) << rank_bits <= 2 ** 31 - 1
    dead = (n_tiles << rank_bits) if packed else (n_tiles << rank_bits) | rank
    key = torch.where(valid, (tile_id << rank_bits) | rank, dead).reshape(-1)
    keys_sorted, sidx = torch.sort(key, stable=True)
    vals_sorted = sidx // W2                                       # gaussian rank
    bounds = torch.searchsorted(
        keys_sorted, torch.arange(n_tiles + 1, device=dev) << rank_bits)
    starts = bounds[:-1]
    counts = torch.clamp(bounds[1:] - starts, max=K)
    gidx = torch.clamp(starts[:, None] + torch.arange(K, device=dev), 0, n * W2 - 1)
    tile_idx = vals_sorted[gidx]
    tile_mask = torch.arange(K, device=dev)[None, :] < counts[:, None]
    return order, tile_idx, tile_mask


def tile_pixels(n_tiles: int, tx: int, tiles_per_frame: int, device,
                dtype=torch.float32):
    """Pixel coordinates (px, py), each (T, 256), of every tile's pixels; a
    tile's origin comes from tile % tiles_per_frame, as in the kernels."""
    P = TILE * TILE
    pix = torch.arange(P, device=device)
    tid = torch.arange(n_tiles, device=device) % tiles_per_frame
    px = (pix % TILE).to(dtype)[None, :] + ((tid % tx) * TILE).to(dtype)[:, None]
    py = (pix // TILE).to(dtype)[None, :] + ((tid // tx) * TILE).to(dtype)[:, None]
    return px, py


def slot_alpha(g: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """The blend's alpha of one slot of every tile, operation for operation
    as the kernels: g (9, T) params, px / py (T, 256) -> (dx, dy, power,
    e = exp(min(power, 0)), op * e, alpha, keep)."""
    dx = px - g[0][:, None]
    dy = py - g[1][:, None]
    power = (-0.5 * (g[2][:, None] * dx * dx + g[4][:, None] * dy * dy)
             - g[3][:, None] * dx * dy)
    e = torch.exp(torch.clamp(power, max=0.0))
    araw = g[5][:, None] * e
    alpha = torch.clamp(araw, max=ALPHA_MAX)
    keep = ~((power > 0.0) | (alpha < ALPHA_MIN))
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    return dx, dy, power, e, araw, alpha, keep


def blend_tiles_plain(slot, n_slots: int, n_tiles: int, tx: int,
                      tiles_per_frame: int, device,
                      dtype=torch.float32) -> torch.Tensor:
    """The plain version of the per-tile walk that kernels S and K1 share
    (csrc/splat_walk.cuh): the same sequential front-to-back rule,
    operation for operation, vectorised over tiles and pixels, one gaussian
    slot per step; every pair is blended here, where the kernels skip the
    dropped ones (an identity, tests/test_torch_splat.py). slot(j) -> (9, T)
    params [mx, my, cxx, cxy, cyy, op, r, g, b] of slot j of every tile
    (op 0 where a tile has no gaussian there) -> (T, 256, 3)."""
    P = TILE * TILE
    px, py = tile_pixels(n_tiles, tx, tiles_per_frame, device, dtype)
    logT = torch.zeros(n_tiles, P, device=device, dtype=dtype)
    acc = torch.zeros(3, n_tiles, P, device=device, dtype=dtype)
    for j in range(n_slots):
        g = slot(j)
        alpha = slot_alpha(g, px, py)[5]
        logT_after = logT + torch.log1p(-alpha)
        w = alpha * torch.exp(logT)
        w = torch.where(torch.exp(logT_after) < T_EPS, torch.zeros_like(w), w)
        acc = acc + w[None] * g[6:9][:, :, None]
        logT = logT_after
    out = torch.clamp(acc + torch.exp(logT)[None], 0.0, 1.0)
    return out.permute(1, 2, 0).contiguous()
