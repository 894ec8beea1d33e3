"""Batch containers (the JAX package's data/containers.py).

`VideoBatch` carries one batch: video (B, T, 3, H, W) in [0, 1], the SMPL-X
and camera parameter dicts, and the optional audio features, image size,
cropped images and point clouds; its fields hold numpy arrays on the host
and tensors once moved (data.synthetic.to_device).
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


def _cat(leaves):
    if all(x is None for x in leaves):
        return None
    if any(x is None for x in leaves):
        raise ValueError("cannot collate: optional field present on only "
                         "some items")
    return np.concatenate(leaves, axis=0)


def collate_video_batches(batches) -> VideoBatch:
    """Stack a list of B = 1 VideoBatch items into one (B, ...) batch along
    axis 0, as the reference's collate functions stack
    `cfg.training.batch_size` dataset items a step."""
    first = batches[0]
    return VideoBatch(
        video=_cat([b.video for b in batches]),
        smpl_parms={k: _cat([b.smpl_parms[k] for b in batches])
                    for k in first.smpl_parms},
        cam_parms={k: _cat([b.cam_parms[k] for b in batches])
                   for k in first.cam_parms},
        audio_features=_cat([b.audio_features for b in batches]),
        width=first.width, height=first.height,
        cropped_images=_cat([b.cropped_images for b in batches]),
        pcd_points=_cat([b.pcd_points for b in batches]),
    )


class CollatedBatches:
    """Groups `batch_size` consecutive (ref, target, idx) items of a
    dataset that yields B = 1 items into (B, ...) batches. The batch id is
    the first item's; a trailing partial group is dropped."""

    def __init__(self, dataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = int(batch_size)

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self):
        buf = []
        for item in self.dataset:
            buf.append(item)
            if len(buf) == self.batch_size:
                refs, tgts, ids = zip(*buf)
                yield (collate_video_batches(refs),
                       collate_video_batches(tgts), ids[0])
                buf = []
