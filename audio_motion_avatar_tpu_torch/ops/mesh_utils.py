"""Mesh geometry helpers (the JAX package's ops/mesh_utils.py): safe
normalisation, face / vertex normals, per-face orientation frames, the
clip-space transform, and a uniform mesh-Laplacian smoothing loss on
host-built neighbour tables of a static topology.
"""

from __future__ import annotations

import numpy as np
import torch


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * y, dim=-1, keepdim=True)


def reflect(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return 2.0 * dot(x, n) * n - x


def length(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return torch.sqrt(torch.clamp(dot(x, x), min=eps))


def safe_normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return x / length(x, eps)


def _corners(verts: torch.Tensor, faces):
    f = torch.as_tensor(np.asarray(faces), dtype=torch.long, device=verts.device)
    return verts[..., f[:, 0], :], verts[..., f[:, 1], :], verts[..., f[:, 2], :], f


def face_normals(verts: torch.Tensor, faces) -> torch.Tensor:
    """verts (..., V, 3), faces (F, 3) -> (..., F, 3), not normalised."""
    v0, v1, v2, _ = _corners(verts, faces)
    return torch.linalg.cross(v1 - v0, v2 - v0)


def vertex_normals(verts: torch.Tensor, faces) -> torch.Tensor:
    """Area-weighted vertex normals (each face's normal added to its three
    corners); a vertex whose sum is degenerate gets +z."""
    v0, v1, v2, f = _corners(verts, faces)
    fn = torch.linalg.cross(v1 - v0, v2 - v0)
    vn = torch.zeros_like(verts)
    for k in range(3):
        vn = vn.index_add(-2, f[:, k], fn)
    bad = dot(vn, vn) <= 1e-20
    vn = torch.where(bad, torch.tensor([0.0, 0.0, 1.0], dtype=vn.dtype, device=vn.device), vn)
    return safe_normalize(vn)


def face_orientation(verts: torch.Tensor, faces):
    """Per-face orthonormal frame (..., F, 3, 3) (columns: the first edge,
    the normal, their cross product) and scale (..., F, 1)."""
    v0, v1, v2, _ = _corners(verts, faces)
    a0 = safe_normalize(v1 - v0)
    a1 = safe_normalize(torch.linalg.cross(a0, v2 - v0))
    a2 = -safe_normalize(torch.linalg.cross(a1, a0))
    orient = torch.stack([a0, a1, a2], dim=-1)
    s0 = length(v1 - v0)
    s1 = torch.abs(dot(a2, v2 - v0))
    return orient, (s0 + s1) / 2.0


def clip_from_world(points: torch.Tensor, view: torch.Tensor,
                    proj: torch.Tensor) -> torch.Tensor:
    """World points (..., 3) -> homogeneous clip coordinates (..., 4)."""
    p = torch.cat([points, torch.ones_like(points[..., :1])], -1)
    return p @ (proj @ view).T


def build_laplacian(num_verts: int, faces: np.ndarray):
    """Uniform-Laplacian neighbour tables of a static topology, built on the
    host: (neighbours (V, Dmax) int32, sorted; mask (V, Dmax) bool)."""
    adj = [set() for _ in range(num_verts)]
    for a, b, c in np.asarray(faces):
        adj[a].update((b, c))
        adj[b].update((a, c))
        adj[c].update((a, b))
    dmax = max(1, max(len(s) for s in adj))
    nbr = np.zeros((num_verts, dmax), np.int32)
    mask = np.zeros((num_verts, dmax), bool)
    for i, s in enumerate(adj):
        ns = sorted(s)
        nbr[i, :len(ns)] = ns
        mask[i, :len(ns)] = True
    return nbr, mask


def laplacian_smoothing_loss(verts: torch.Tensor, nbr: np.ndarray,
                             mask: np.ndarray) -> torch.Tensor:
    """Mean over vertices of |centroid of the neighbours - vertex| (the
    uniform mesh-Laplacian smoothing loss)."""
    idx = torch.as_tensor(np.asarray(nbr), dtype=torch.long, device=verts.device)
    m = torch.as_tensor(np.asarray(mask), dtype=verts.dtype, device=verts.device)[..., None]
    neigh = verts[..., idx.reshape(-1), :].reshape(verts.shape[:-2] + idx.shape + (3,))
    deg = torch.clamp(m.sum(-2), min=1.0)
    center = (neigh * m).sum(-2) / deg
    return torch.linalg.norm(center - verts, dim=-1).mean()
