"""Batch containers (the JAX package's data/containers.py).

`VideoBatch` carries one batch: video (B, T, 3, H, W) in [0, 1], the SMPL-X
and camera parameter dicts, and the optional audio features, image size,
cropped images and point clouds; its fields hold numpy arrays on the host
and tensors once moved to the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class VideoBatch(NamedTuple):
    video: np.ndarray          # (B, T, 3, H, W) in [0, 1]
    smpl_parms: dict           # (B, T, ...) axis-angle parts
    cam_parms: dict            # intrinsic (B, T, 3, 3), extrinsic (B, T, 4, 4)
    audio_features: Optional[np.ndarray] = None   # (B, T_audio, C)
    width: Optional[int] = None
    height: Optional[int] = None
    cropped_images: Optional[np.ndarray] = None
    pcd_points: Optional[np.ndarray] = None
