"""Static mesh subdivision tables (host numpy) applied as gathers.

Midpoint subdivision of the static SMPL-X topology, `steps` times, then a
frozen random sub-selection to a fixed count. Tables are built once on the
host; `apply_subdivision` runs on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..utils import profiling


class SubdivisionTables(NamedTuple):
    edges: Tuple[np.ndarray, ...]    # each (E_i, 2) int32 into the previous level
    faces: Tuple[np.ndarray, ...]    # faces after each step, (F_i, 3)
    num_verts: Tuple[int, ...]       # vertex count after each step


def _subdivide_once(num_verts: int, faces: np.ndarray):
    """One midpoint step: (edges (E, 2) sorted-unique, new_faces (4F, 3)).
    New vertex k is the midpoint of edges[k], index num_verts + k."""
    f = np.asarray(faces, np.int64)
    all_edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], 0)
    all_edges.sort(axis=1)
    edges, inverse = np.unique(all_edges, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    F = f.shape[0]
    m01 = num_verts + inverse[:F]
    m12 = num_verts + inverse[F:2 * F]
    m20 = num_verts + inverse[2 * F:]
    new_faces = np.concatenate([
        np.stack([f[:, 0], m01, m20], 1),
        np.stack([f[:, 1], m12, m01], 1),
        np.stack([f[:, 2], m20, m12], 1),
        np.stack([m01, m12, m20], 1)], 0)
    return edges.astype(np.int32), new_faces.astype(np.int32)


def build_subdivision(num_verts: int, faces: np.ndarray,
                      steps: int) -> SubdivisionTables:
    edges_list, faces_list, counts = [], [], []
    cur_faces = np.asarray(faces, np.int32)
    cur_n = num_verts
    for _ in range(steps):
        edges, cur_faces = _subdivide_once(cur_n, cur_faces)
        cur_n += edges.shape[0]
        edges_list.append(edges)
        faces_list.append(cur_faces)
        counts.append(cur_n)
    return SubdivisionTables(tuple(edges_list), tuple(faces_list), tuple(counts))


def apply_subdivision(verts: torch.Tensor,
                      tables: SubdivisionTables) -> torch.Tensor:
    """(..., V, 3) -> (..., V', 3) by appending edge midpoints per step."""
    out = verts
    for edges in tables.edges:
        with profiling.host_sync("subdivision.edges"):
            e = torch.as_tensor(edges.astype(np.int64), device=verts.device)
        mids = 0.5 * (out[..., e[:, 0], :] + out[..., e[:, 1], :])
        out = torch.cat([out, mids], -2)
    return out


def face_center_densify(verts: torch.Tensor, faces: np.ndarray) -> torch.Tensor:
    """verts (..., V, 3) + static faces (F, 3) -> (..., V + F, 3): the
    face centroids appended (the stage-1 encoder's densification). The
    centroid is the sum times 1/3, as XLA lowers the JAX package's mean."""
    with profiling.host_sync("subdivision.faces"):
        f = torch.as_tensor(np.asarray(faces, np.int64), device=verts.device)
    fv = verts[..., f.reshape(-1), :].reshape(verts.shape[:-2] + (f.shape[0], 3, 3))
    return torch.cat([verts, fv.sum(-2) * (1.0 / 3.0)], -2)


def fixed_subselect(num_available: int, num_keep: int,
                    seed: int = 0) -> np.ndarray:
    """Frozen random permutation prefix (the reference redraws per call)."""
    rng = np.random.RandomState(seed)
    return rng.permutation(num_available)[:num_keep].astype(np.int32)
