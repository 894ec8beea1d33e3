"""Debug visualizers on the host (a numpy copy of the JAX package's
utils/graphics.py, pixel for pixel the same): a software rasterizer for
the SMPL-X mesh overlay of the demo's frames (the reference draws it with
pyrender) and a PCA image of a triplane. Never on the device.
"""

from __future__ import annotations

import numpy as np


def rasterize_mesh_overlay(image: np.ndarray, verts: np.ndarray,
                           faces: np.ndarray, K: np.ndarray, E: np.ndarray,
                           color=(0.4, 0.8, 1.0), alpha: float = 0.55) -> np.ndarray:
    """Flat-shaded z-buffered triangle overlay of a mesh on an image.

    image: (H, W, 3) float [0,1]; verts (V,3) world; faces (F,3); K 3x3; E 4x4.
    Software scanline rasterizer — fine for debug overlays at video rates on
    a few thousand faces.
    """
    H, W = image.shape[:2]
    cam = verts @ E[:3, :3].T + E[:3, 3]
    z = cam[:, 2]
    valid = z > 1e-4
    uv = (cam @ K.T)
    uv = uv[:, :2] / np.clip(uv[:, 2:3], 1e-6, None)

    # simple diffuse shading from face normals
    f = faces
    tri_cam = cam[f]  # (F, 3, 3)
    n = np.cross(tri_cam[:, 1] - tri_cam[:, 0], tri_cam[:, 2] - tri_cam[:, 0])
    n_norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.clip(n_norm, 1e-9, None)
    shade = np.clip(-n[:, 2], 0.15, 1.0)  # light along +z

    zbuf = np.full((H, W), np.inf, np.float32)
    overlay = image.copy()
    col = np.asarray(color, np.float32)

    tri_uv = uv[f]          # (F, 3, 2)
    tri_z = z[f].mean(-1)   # per-face depth (flat)
    tri_ok = valid[f].all(-1)
    order = np.argsort(-tri_z)  # back to front for overlay blending w/ zbuf

    for fi in order:
        if not tri_ok[fi]:
            continue
        pts = tri_uv[fi]
        x0, y0 = np.floor(pts.min(0)).astype(int)
        x1, y1 = np.ceil(pts.max(0)).astype(int)
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, W - 1), min(y1, H - 1)
        if x1 < x0 or y1 < y0:
            continue
        xs, ys = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1))
        # barycentric inside-test
        a, b, c = pts
        det = (b[1] - c[1]) * (a[0] - c[0]) + (c[0] - b[0]) * (a[1] - c[1])
        if abs(det) < 1e-9:
            continue
        l1 = ((b[1] - c[1]) * (xs - c[0]) + (c[0] - b[0]) * (ys - c[1])) / det
        l2 = ((c[1] - a[1]) * (xs - c[0]) + (a[0] - c[0]) * (ys - c[1])) / det
        l3 = 1.0 - l1 - l2
        inside = (l1 >= 0) & (l2 >= 0) & (l3 >= 0)
        if not inside.any():
            continue
        zi = tri_z[fi]
        sub = zbuf[y0:y1 + 1, x0:x1 + 1]
        upd = inside & (zi < sub)
        sub[upd] = zi
        px = overlay[y0:y1 + 1, x0:x1 + 1]
        blend = (1 - alpha) * px + alpha * (col * shade[fi])
        px[upd] = blend[upd]
    return overlay


def draw_smplx_on_image(image: np.ndarray, verts: np.ndarray,
                        faces: np.ndarray, K: np.ndarray, E: np.ndarray,
                        transl=None) -> np.ndarray:
    """graphic_utils.draw_smplx_on_image analog: overlay the posed body."""
    v = np.asarray(verts)
    if transl is not None:
        v = v + np.asarray(transl).reshape(1, 3)
    return rasterize_mesh_overlay(np.asarray(image), v, np.asarray(faces),
                                  np.asarray(K), np.asarray(E))


def visualize_triplane_pca(planes: np.ndarray) -> np.ndarray:
    """(3, C, H, W) triplane -> (H, 3*W, 3) PCA-RGB image
    (graphic_utils.py:950-1010 without matplotlib/sklearn)."""
    out = []
    for p in range(3):
        x = np.asarray(planes[p], np.float32)  # (C, H, W)
        C, H, W = x.shape
        flat = x.reshape(C, -1).T  # (HW, C)
        mu = flat.mean(0)
        xc = flat - mu
        # top-3 principal components via SVD
        _, _, vt = np.linalg.svd(xc, full_matrices=False)
        rgb = xc @ vt[:3].T  # (HW, 3)
        rgb = (rgb - rgb.min(0)) / np.clip(rgb.max(0) - rgb.min(0), 1e-9, None)
        out.append(rgb.reshape(H, W, 3))
    return np.concatenate(out, axis=1)
