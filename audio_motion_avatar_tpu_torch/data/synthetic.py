"""Synthetic batches: random body pose, orbiting cameras, noise video.

The numpy part of the JAX package's data/synthetic.py (`random_smpl_params`,
`make_batch`, with `ops.cameras.orbit_camera`), drawing the same numbers
from the same seed, so that a test or the chip smoke test can feed both
packages one batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import smplx as smplx_ops
from ..ops.cameras import orbit_camera


class VideoBatch(NamedTuple):
    video: np.ndarray          # (B, T, 3, H, W) in [0, 1]
    smpl_parms: dict           # (B, T, ...) axis-angle parts
    cam_parms: dict            # intrinsic (B, T, 3, 3), extrinsic (B, T, 4, 4)
    audio_features: Optional[np.ndarray] = None   # (B, T_audio, C)


def random_smpl_params(rng: np.random.RandomState, shape, pose_scale=0.2,
                       num_expr=10) -> dict:
    def r(*dims):
        return (rng.randn(*shape, *dims) * pose_scale).astype(np.float32)

    return {
        "global_orient": r(3) * 0.3,
        "body_pose": r(smplx_ops.NUM_BODY_JOINTS * 3),
        "betas": (rng.randn(*shape, 10) * 0.3).astype(np.float32),
        "left_hand_pose": r(smplx_ops.NUM_HAND_JOINTS * 3),
        "right_hand_pose": r(smplx_ops.NUM_HAND_JOINTS * 3),
        "jaw_pose": r(3) * 0.2,
        "leye_pose": r(3) * 0.1,
        "reye_pose": r(3) * 0.1,
        "expression": (rng.randn(*shape, num_expr) * 0.3).astype(np.float32),
        "transl": np.tile(np.array([0, 0.0, 0], np.float32), (*shape, 1)),
    }


def make_batch(batch_size=1, num_frames=2, image_size=(64, 64), seed=0,
               num_expr=10, with_audio=False, audio_dim=768,
               audio_frames=None) -> VideoBatch:
    """One (B, T) batch: random body pose, orbiting cameras, noise video."""
    rng = np.random.RandomState(seed)
    H, W = image_size
    B, T = batch_size, num_frames
    Ks, Es = [], []
    for b in range(B):
        for t in range(T):
            K, E = orbit_camera(angle=0.3 * t + 0.1 * b, image_size=image_size,
                                focal=max(H, W) * 1.2)
            Ks.append(K)
            Es.append(E)
    cam = {"intrinsic": np.stack(Ks).reshape(B, T, 3, 3),
           "extrinsic": np.stack(Es).reshape(B, T, 4, 4)}
    video = rng.rand(B, T, 3, H, W).astype(np.float32)
    smpl = random_smpl_params(rng, (B, T), num_expr=num_expr)
    audio = None
    if with_audio:
        audio = rng.randn(B, audio_frames or num_frames,
                          audio_dim).astype(np.float32)
    return VideoBatch(video, smpl, cam, audio)


def to_device(batch: VideoBatch, device) -> VideoBatch:
    """The batch's arrays as tensors on `device`."""
    def t(a):
        return None if a is None else torch.as_tensor(a, device=device)

    return VideoBatch(t(batch.video),
                      {k: t(v) for k, v in batch.smpl_parms.items()},
                      {k: t(v) for k, v in batch.cam_parms.items()},
                      t(batch.audio_features))
