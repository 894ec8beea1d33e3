"""Closed-loop stage-1 reconstruction: one caller sends a reference view
with its SMPL-X parameters and the novel cameras, waits for the avatar's
views and metrics, sends the next.

Each request is drawn on the device from the seed: a `ref_views` noise
video at `image_size`, random SMPL-X parameters (the port's synthetic
distribution), an orbiting reference camera and `novel_views` cameras
spread round the body with their own noise targets. It goes through the
port's `reconstruct.Reconstructor.__call__`.

Traffic keys: driver, image_size [H, W], batch, ref_views, novel_views,
orbit_step (radians a request), warmup_requests, sample (requests
compared), profile_requests.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..reference import entry as ref
from ..reference.plain_avatar.data.containers import VideoBatch
from ..reference.plain_avatar.ops import smplx as smplx_ref
from ..reference.plain_avatar.ops.cameras import orbit_camera
from .common import SeededDriver, Sampler, free, peak_bytes, reset_peak, sync, to_host

KINDS = {"tri": "token", "smpl": "token", "pred": "leaf", "gaussians": "signal",
         "reference": "frame", "novel": "frame", "metrics": "leaf"}


def answer(rec) -> dict:
    """The outputs of a port Reconstruction that are compared."""
    return {"tri": rec.output.triplane_tokens, "smpl": rec.output.smpl_tokens,
            "pred": rec.output.pred_smpl_2, "pred_1": rec.output.pred_smpl_1,
            "pred_2": rec.output.pred_smpl_2,
            "gaussians": {k: rec.gaussians[k] for k in ref.GAUSSIAN_KEYS},
            "reference": rec.reference, "novel": rec.novel, "metrics": rec.metrics}


class Driver(SeededDriver):
    kind, kinds, stages = "recon", KINDS, staticmethod(ref.recon_stages)

    def setup(self) -> None:
        from audio_motion_avatar_tpu_torch.reconstruct import build_reconstructor

        self.rec = self.system = self.build_port(build_reconstructor)
        self.gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        self.i = 0

        def warmup():
            for _ in range(self.traffic["warmup_requests"]):
                self._one(self._draw())
        self.timed("warmup", warmup)

    def _cams(self, angles, H, W):
        Ks, Es = zip(*(orbit_camera(angle=a, image_size=(H, W), focal=max(H, W) * 1.2)
                       for a in angles))
        B = self.traffic["batch"]
        n = len(angles) // B

        def t(x, shape):
            return torch.as_tensor(np.stack(x), device=self.device).reshape(B, n, *shape)
        return {"intrinsic": t(Ks, (3, 3)), "extrinsic": t(Es, (4, 4))}

    def _draw(self) -> tuple:
        """Request `self.i`: (ref batch, test batch) as the reference's
        VideoBatch of tensors on the device."""
        tr, g, dev = self.traffic, self.gen, self.device
        B, T, V = tr["batch"], tr["ref_views"], tr["novel_views"]
        H, W = tr["image_size"]

        def r(*dims, scale=1.0):
            return torch.randn(B, T, *dims, generator=g, device=dev) * scale

        smpl = {"global_orient": r(3, scale=0.06),
                "body_pose": r(smplx_ref.NUM_BODY_JOINTS * 3, scale=0.2),
                "betas": r(10, scale=0.3),
                "left_hand_pose": r(smplx_ref.NUM_HAND_JOINTS * 3, scale=0.2),
                "right_hand_pose": r(smplx_ref.NUM_HAND_JOINTS * 3, scale=0.2),
                "jaw_pose": r(3, scale=0.04), "leye_pose": r(3, scale=0.02),
                "reye_pose": r(3, scale=0.02),
                "expression": r(self.ref_cfg.num_expression_coeffs, scale=0.3),
                "transl": torch.zeros(B, T, 3, device=dev)}
        a0 = tr["orbit_step"] * self.i
        self.i += 1
        ref_b = VideoBatch(torch.rand(B, T, 3, H, W, generator=g, device=dev), smpl,
                           self._cams([a0 + 0.1 * b + 0.3 * t for b in range(B) for t in range(T)], H, W),
                           width=W, height=H)
        test_b = VideoBatch(torch.rand(B, V, 3, H, W, generator=g, device=dev), smpl,
                            self._cams([a0 + 0.1 * b + 2 * math.pi * v / V
                                        for b in range(B) for v in range(V)], H, W),
                            width=W, height=H)
        return ref_b, test_b

    def _one(self, batches):
        from audio_motion_avatar_tpu_torch.data.containers import VideoBatch as PortBatch

        out = self.rec(*(PortBatch(*b) for b in batches))
        sync(self.device)
        return out

    # ---- the window ---------------------------------------------------------
    def window(self, seconds: float, spans=None) -> dict:
        sampler = Sampler(self.seed, self.traffic["sample"])
        sync(self.device)
        reset_peak(self.device)
        if spans is not None:
            spans.on = True
        lat, n, copied = [], 0, 0.0
        per = self.traffic["batch"] * (self.traffic["ref_views"] + self.traffic["novel_views"])
        t0 = time.perf_counter()
        while True:
            keep = sampler.slot(n)
            batches = self._draw()
            a = time.perf_counter()
            out = self._one(batches)
            b = time.perf_counter()
            lat.append(b - a)
            if keep is not None:
                keep.update(inputs=batches, **answer(out))
                copied += to_host(keep)
            del out
            n += 1
            window_s = time.perf_counter() - t0 - copied
            if window_s >= seconds:
                break
        if spans is not None:
            spans.on = False
        self.samples = sampler.kept()
        return {"window_s": window_s, "latencies_s": lat, "frames": n * per,
                "peak_mem_bytes": peak_bytes(self.device)}

    def run_requests(self, n: int) -> None:
        for _ in range(n):
            self._one(self._draw())

    def release(self) -> None:
        del self.rec, self.system
        free(self.device)
