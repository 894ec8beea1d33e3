"""Synthetic data: random body pose, orbiting cameras, noise or rendered
video (the JAX package's data/synthetic.py).

`random_smpl_params` and `make_batch` draw the same numbers from the same
seed as the JAX package's, so that a test or the chip smoke test can feed
both packages one batch. `SyntheticDataset` yields the (ref, target,
batch id) items of the demo and the tests; with `render_gt` its videos are
a fixed gaussian body rendered from each batch's own SMPL-X parameters and
cameras (`render_gt_video`: the port's tile splat, K1 on the card) instead
of noise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import smplx as smplx_ops
from ..ops.cameras import orbit_camera
from .containers import VideoBatch


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
    return VideoBatch(video, smpl, cam, audio, width=W, height=H)


def to_device(batch: VideoBatch, device) -> VideoBatch:
    """The batch's arrays as tensors on `device`."""
    def t(a):
        return None if a is None else torch.as_tensor(a, device=device)

    return batch._replace(video=t(batch.video),
                          smpl_parms={k: t(v) for k, v in batch.smpl_parms.items()},
                          cam_parms={k: t(v) for k, v in batch.cam_parms.items()},
                          audio_features=t(batch.audio_features),
                          cropped_images=t(batch.cropped_images),
                          pcd_points=t(batch.pcd_points))


@torch.no_grad()
def render_gt_video(smplx_model: smplx_ops.SmplxModel, batch: VideoBatch,
                    image_size, device="cpu") -> np.ndarray:
    """A fittable target for a batch instead of its noise video: a fixed
    gaussian body (the vertices posed by the batch's own SMPL-X params,
    smooth dark positional colours) rendered from the batch's own cameras
    on `device`. smplx_model: numpy. Returns (B, T, 3, H, W) float32."""
    from ..ops.splat_tiles import render_batch

    H, W = image_size
    B, T = np.asarray(batch.cam_parms["extrinsic"]).shape[:2]
    model = smplx_ops.as_tensors(smplx_model, device)
    params = {k: torch.as_tensor(np.asarray(v), device=device)
              for k, v in batch.smpl_parms.items()}
    verts = smplx_ops.forward(model, params).reshape(B, T, -1, 3)
    N = verts.shape[2]
    v0 = verts[0, 0]
    colors = 0.32 + 0.28 * torch.sin(
        v0 * torch.tensor([9.0, 7.0, 11.0], device=device)
        + torch.tensor([0.0, 2.1, 4.2], device=device))
    gaussians = {
        "xyz": verts,
        "rot": torch.tensor([1.0, 0, 0, 0], device=device).expand(B, T, N, 4),
        # activated scale min(exp(s - 3.9), 0.1): ~2.5 % of the body's size
        "scale": torch.full((B, T, N, 3), math.log(0.025) + 3.9, device=device),
        "opacity": torch.full((B, T, N), 4.0, device=device),
        "color": colors.expand(B, T, N, 3),
    }

    def cam(k):
        return torch.as_tensor(np.asarray(batch.cam_parms[k]), device=device)

    imgs = render_batch(gaussians, cam("intrinsic"), cam("extrinsic"), W, H)
    return imgs.permute(0, 1, 4, 2, 3).float().cpu().numpy()


class SyntheticDataset:
    """Indexable dataset of (ref_batch, target_batch, batch_id) items."""

    def __init__(self, length=8, batch_size=1, ref_frames=2, target_frames=6,
                 image_size=(64, 64), with_audio=False, audio_dim=768, seed=0,
                 render_gt=False, device="cpu"):
        self.length = length
        self.kw = dict(batch_size=batch_size, image_size=image_size)
        self.ref_frames = ref_frames
        self.target_frames = target_frames
        self.with_audio = with_audio
        self.audio_dim = audio_dim
        self.seed = seed
        # render_gt: render a reachable body target instead of noise video;
        # the body is a small synthetic SMPL-X (400 vertices), a fit target
        # only, independent of the model's own body. device: where it is
        # rendered.
        self.render_gt = bool(render_gt)
        self.device = device
        self._smplx = None

    def __len__(self):
        return self.length

    def _gt(self, batch: VideoBatch) -> VideoBatch:
        if self._smplx is None:
            self._smplx = smplx_ops.synthetic_model(seed=0, num_verts=400)
        return batch._replace(video=render_gt_video(
            self._smplx, batch, self.kw["image_size"], self.device))

    def __getitem__(self, i):
        ref = make_batch(num_frames=self.ref_frames, seed=self.seed + i, **self.kw)
        tgt = make_batch(num_frames=self.target_frames, seed=self.seed + 1000 + i,
                         with_audio=self.with_audio, audio_dim=self.audio_dim,
                         **self.kw)
        if self.render_gt:
            ref, tgt = self._gt(ref), self._gt(tgt)
        return ref, tgt, i

    def __iter__(self):
        for i in range(self.length):
            yield self[i]
