"""SMPL-X body model: blend shapes + forward kinematics + LBS (fp32).

`synthetic_model()` builds the same numpy arrays as the JAX package's
stand-in from the same seed (tests check this), so every test and the chip
smoke test run without the proprietary SMPL-X asset; `load_model()` reads
the released one when it is there. `as_tensors()` moves a
model onto a device. The kinematic chain is unrolled over the static tree.
`forward` runs with TF32 off (device.fp32_geometry): at TF32 or bf16 the
55-joint chain loses ~1e-3 of vertex accuracy.
"""

from __future__ import annotations

import os
import pickle
from typing import NamedTuple

import numpy as np
import torch

from ..device import fp32_geometry
from .rotations import axis_angle_to_matrix

NUM_BODY_JOINTS = 21
NUM_HAND_JOINTS = 15
NUM_FACE_JOINTS = 3
NUM_JOINTS = 1 + NUM_BODY_JOINTS + NUM_FACE_JOINTS + 2 * NUM_HAND_JOINTS  # 55
SMPLX_NUM_VERTS = 10475


class SmplxModel(NamedTuple):
    v_template: object     # (V, 3)
    shapedirs: object      # (V, 3, num_betas)
    exprdirs: object       # (V, 3, num_expr)
    posedirs: object       # ((J-1)*9, V*3)
    J_regressor: object    # (J, V)
    parents: np.ndarray    # (J,) int32, parents[0] == -1 (host value)
    lbs_weights: object    # (V, J)
    left_hand_mean: object   # (45,)
    right_hand_mean: object  # (45,)
    faces: np.ndarray      # (F, 3) int32 (host value)


def as_tensors(model: SmplxModel, device, dtype=torch.float32) -> SmplxModel:
    """numpy model -> the same model with float tensors on `device`; the
    topology (parents, faces) stays host numpy."""
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return SmplxModel(
        v_template=t(model.v_template), shapedirs=t(model.shapedirs),
        exprdirs=t(model.exprdirs), posedirs=t(model.posedirs),
        J_regressor=t(model.J_regressor),
        parents=np.asarray(model.parents, np.int32),
        lbs_weights=t(model.lbs_weights),
        left_hand_mean=t(model.left_hand_mean),
        right_hand_mean=t(model.right_hand_mean),
        faces=np.asarray(model.faces, np.int32))


@fp32_geometry()
def forward(model: SmplxModel, params: dict, *, flat_hand_mean: bool = True,
            apply_transl: bool = False) -> torch.Tensor:
    """params (axis-angle parts, any leading dims) -> vertices (B, V, 3)."""
    go = params["global_orient"]
    B = int(np.prod(go.shape[:-1])) if go.dim() > 1 else 1
    go = go.reshape(B, 3)
    body = params["body_pose"].reshape(B, NUM_BODY_JOINTS * 3)
    betas = params["betas"].reshape(B, -1)
    lhand = params["left_hand_pose"].reshape(B, NUM_HAND_JOINTS * 3)
    rhand = params["right_hand_pose"].reshape(B, NUM_HAND_JOINTS * 3)
    jaw = params["jaw_pose"].reshape(B, 3)
    leye = params["leye_pose"].reshape(B, 3)
    reye = params["reye_pose"].reshape(B, 3)
    expr = params["expression"].reshape(B, -1)
    if not flat_hand_mean:
        lhand = lhand + model.left_hand_mean
        rhand = rhand + model.right_hand_mean
    full_pose = torch.cat([go, body, jaw, leye, reye, lhand, rhand], -1)
    verts = lbs(model, betas, expr, full_pose.reshape(B, NUM_JOINTS, 3))
    if apply_transl and "transl" in params:
        verts = verts + params["transl"].reshape(B, 1, 3)
    return verts


def lbs(model: SmplxModel, betas: torch.Tensor, expression: torch.Tensor,
        full_pose_aa: torch.Tensor) -> torch.Tensor:
    """betas (B, Nb), expression (B, Ne), full_pose_aa (B, J, 3) -> (B, V, 3)."""
    B = betas.shape[0]
    nb, ne = betas.shape[-1], expression.shape[-1]
    v_shaped = (model.v_template[None]
                + torch.einsum("bl,vcl->bvc", betas, model.shapedirs[..., :nb])
                + torch.einsum("bl,vcl->bvc", expression,
                               model.exprdirs[..., :ne]))
    joints = torch.einsum("jv,bvc->bjc", model.J_regressor, v_shaped)

    rot_mats = axis_angle_to_matrix(full_pose_aa)             # (B, J, 3, 3)
    eye = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - eye).reshape(B, -1)
    v_posed = v_shaped + (pose_feature @ model.posedirs).reshape(B, -1, 3)

    parents = model.parents
    rel_joints = joints.clone()
    rel_joints[:, 1:] -= joints[:, torch.as_tensor(parents[1:].astype(np.int64))]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot_mats.dtype,
                          device=rot_mats.device).expand(B, NUM_JOINTS, 1, 4)
    transforms_mat = torch.cat(
        [torch.cat([rot_mats, rel_joints[..., None]], -1), bottom], -2)

    chains = [transforms_mat[:, 0]]
    for j in range(1, NUM_JOINTS):
        chains.append(chains[parents[j]] @ transforms_mat[:, j])
    transforms = torch.stack(chains, 1)                       # (B, J, 4, 4)

    joints_h = torch.cat([joints, joints.new_zeros(B, NUM_JOINTS, 1)], -1)
    corr = torch.einsum("bjxy,bjy->bjx", transforms, joints_h)[..., :3]
    rel = transforms.clone()
    rel[..., :3, 3] -= corr

    T = torch.einsum("vj,bjxy->bvxy", model.lbs_weights, rel)
    return (torch.einsum("bvxy,bvy->bvx", T[..., :3, :3], v_posed)
            + T[..., :3, 3])


def load_model(path: str, num_betas: int = 10, num_expr: int = 10,
               dtype=np.float32) -> SmplxModel:
    """Load the released SMPLX_NEUTRAL model (.npz or .pkl, or a directory
    holding one) as numpy arrays, in the smplx package's field layout:
    shapedirs[..., :300] are the shape components (the first `num_betas`
    used) and [..., 300:300 + num_expr] the expression components."""
    if os.path.isdir(path):
        for cand in ("SMPLX_NEUTRAL.npz", "SMPLX_NEUTRAL.pkl"):
            p = os.path.join(path, cand)
            if os.path.exists(p):
                path = p
                break
    if path.endswith(".npz"):
        data = dict(np.load(path, allow_pickle=True))
    else:
        with open(path, "rb") as f:
            raw = pickle.load(f, encoding="latin1")
        data = {k: np.asarray(v) for k, v in raw.items() if not isinstance(v, str)}

    shapedirs_all = np.asarray(data["shapedirs"], dtype)
    if shapedirs_all.shape[-1] > 300:  # full release: 300 shape + 100 expression
        shapedirs = shapedirs_all[..., :num_betas]
        exprdirs = shapedirs_all[..., 300:300 + num_expr]
    else:
        shapedirs = shapedirs_all[..., :num_betas]
        exprdirs = shapedirs_all[..., num_betas:num_betas + num_expr]

    posedirs = np.asarray(data["posedirs"], dtype)
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T  # (P, V*3)

    parents = np.asarray(data["kintree_table"])[0].astype(np.int32)
    parents[0] = -1
    parents = parents[:NUM_JOINTS]

    return SmplxModel(
        v_template=np.asarray(data["v_template"], dtype),
        shapedirs=np.ascontiguousarray(shapedirs),
        exprdirs=np.ascontiguousarray(exprdirs),
        posedirs=np.ascontiguousarray(posedirs[: (NUM_JOINTS - 1) * 9]),
        J_regressor=np.asarray(data["J_regressor"], dtype)[:NUM_JOINTS],
        parents=parents,
        lbs_weights=np.asarray(data["weights"], dtype)[:, :NUM_JOINTS],
        left_hand_mean=np.asarray(data.get("hands_meanl", np.zeros(45)), dtype),
        right_hand_mean=np.asarray(data.get("hands_meanr", np.zeros(45)), dtype),
        faces=np.asarray(data["f"], np.int32),
    )


def _grid_faces(rows: int, cols: int) -> np.ndarray:
    faces = []
    for r in range(rows - 1):
        for c in range(cols - 1):
            a = r * cols + c
            b = a + 1
            d = a + cols
            e = d + 1
            faces.append((a, b, d))
            faces.append((b, e, d))
    return np.asarray(faces, np.int32)


def synthetic_model(seed: int = 0, num_verts: int = SMPLX_NUM_VERTS,
                    num_betas: int = 10, num_expr: int = 10,
                    dtype=np.float32) -> SmplxModel:
    """Structurally faithful random SMPL-X stand-in, as numpy arrays: a
    vertically stretched blob, the real SMPL-X kinematic tree, smooth
    regressor and skinning weights."""
    rng = np.random.RandomState(seed)
    v = rng.randn(num_verts, 3).astype(dtype)
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    v *= np.array([0.25, 0.8, 0.15], dtype)
    v += 0.02 * rng.randn(num_verts, 3).astype(dtype)

    parents = np.array([
        -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
        18, 19, 15, 22, 23, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35,
        20, 37, 38, 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53,
    ], np.int32)

    jpos = 0.1 * rng.randn(NUM_JOINTS, 3).astype(dtype)
    jpos[:, 1] += np.linspace(-0.8, 0.8, NUM_JOINTS).astype(dtype)
    d2 = ((v[None] - jpos[:, None]) ** 2).sum(-1)              # (J, V)
    Jreg = np.exp(-d2 / 0.02)
    Jreg = (Jreg / np.clip(Jreg.sum(-1, keepdims=True), 1e-8, None)).astype(dtype)
    W = np.exp(-d2.T / 0.05)
    W = (W / np.clip(W.sum(-1, keepdims=True), 1e-8, None)).astype(dtype)

    rows = int(np.floor(np.sqrt(num_verts)))
    faces = _grid_faces(rows, num_verts // rows)
    # draw, cast, then scale in `dtype` (the scaled values round as the JAX
    # package's do)
    return SmplxModel(
        v_template=v,
        shapedirs=0.01 * rng.randn(num_verts, 3, num_betas).astype(dtype),
        exprdirs=0.003 * rng.randn(num_verts, 3, num_expr).astype(dtype),
        posedirs=0.001 * rng.randn((NUM_JOINTS - 1) * 9,
                                   num_verts * 3).astype(dtype),
        J_regressor=Jreg, parents=parents, lbs_weights=W,
        left_hand_mean=np.zeros(45, dtype), right_hand_mean=np.zeros(45, dtype),
        faces=faces)
