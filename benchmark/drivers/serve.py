"""Closed-loop stage-2 serving: one caller sends a request, waits for its
frames, sends the next.

Each request is `streams` streams' next chunk: fresh seeded audio features
(streams, T_out, audio_feature_dim) and orbiting cameras at the traffic's
`image_size`; the token window slides from request to request through the
port's `serve.serve` over its `serve.Rollout`. A run's window starts again
from the seeded initial window, so the first request it times is the
start, and each later one continues from the program's own state.

Traffic keys: driver, image_size [H, W], streams, audio_scale,
orbit_step (radians a frame), cam_cycle (requests before the cameras
repeat), warmup_requests, sample (requests compared), profile_requests.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..reference import entry as ref
from ..reference.plain_avatar.ops.cameras import orbit_camera
from .common import SeededDriver, Sampler, free, peak_bytes, reset_peak, sync, to_host

KINDS = {"tri": "token", "smpl": "token", "pred": "leaf", "gaussians": "signal",
         "frames": "frame"}


class Recorder:
    """The built Rollout, called through this wrapper: it keeps the inputs
    and the answer of a request the sampler chose (`keep` a dict)."""

    def __init__(self, rollout):
        self.rollout = rollout
        self.keep = None

    def __call__(self, tri, smpl, audio, cams):
        out = self.rollout(tri, smpl, audio, cams)
        if self.keep is not None:
            self.keep.update(inputs=(tri, smpl, audio, cams), frames=out[0], tri=out[1],
                             smpl=out[2], pred=out[3])
        return out


class Driver(SeededDriver):
    kind, kinds, stages = "serve", KINDS, staticmethod(ref.serve_stages)

    def setup(self) -> None:
        from audio_motion_avatar_tpu_torch.serve import build_rollout

        self.rollout = self.system = self.build_port(build_rollout)
        self.recorder = Recorder(self.rollout)
        model = self.rollout.model
        self.hooks = [model.audio_triplane.register_forward_hook(self._tokens),
                      model.renderer.register_forward_hook(self._gaussians)]
        self.timed("inputs", self._inputs)

        def warmup():
            stream = self._stream()
            for _ in range(self.traffic["warmup_requests"]):
                self._next(stream)
        self.timed("warmup", warmup)

    def _tokens(self, module, args, out):
        if self.recorder.keep is not None:
            self.recorder.keep.update(out_tri=out[0], out_smpl=out[1])

    def _gaussians(self, module, args, out):
        if self.recorder.keep is not None:
            self.recorder.keep["gaussians"] = {k: out[1][k] for k in ref.GAUSSIAN_KEYS}

    def _inputs(self) -> None:
        """The seeded initial window and camera cycle; audio is drawn per
        request from the input generator."""
        cfg, tr, dev = self.ref_cfg, self.traffic, self.device
        B, T_in, T_out = tr["streams"], cfg.triplane_input_frames, cfg.triplane_output_frames
        C, L, S = cfg.triplane_feature_dim, cfg.smpl_token_len, 3 * cfg.triplane_resolution ** 2
        self.gen = torch.Generator(device=dev).manual_seed(self.seed + 1)
        self.tri0 = torch.randn(B, T_in, C, S, generator=self.gen, device=dev) * 0.1
        self.smpl0 = torch.randn(B, T_in, C, L, generator=self.gen, device=dev) * 0.1
        H, W = tr["image_size"]
        self.cams = []
        for i in range(tr["cam_cycle"]):
            Ks, Es = zip(*(orbit_camera(angle=tr["orbit_step"] * (i * T_out + t) + 0.1 * b,
                                        image_size=(H, W), focal=max(H, W) * 1.2)
                           for b in range(B) for t in range(T_out)))
            self.cams.append({
                "intrinsic": torch.as_tensor(np.stack(Ks), device=dev).reshape(B, T_out, 3, 3),
                "extrinsic": torch.as_tensor(np.stack(Es), device=dev).reshape(B, T_out, 4, 4)})
        self.audio_shape = (B, T_out, cfg.audio_feature_dim)
        self.frames_per_request = B * T_out

    def _stream(self):
        """A fresh serve.serve stream from the initial window; its requests
        come from `self.pending`, set before each is timed."""
        from audio_motion_avatar_tpu_torch.serve import serve

        self.i = 0

        def requests():
            while True:
                yield self.pending
        return serve(self.recorder, self.tri0, self.smpl0, requests())

    def _draw(self):
        audio = torch.randn(self.audio_shape, generator=self.gen, device=self.device)
        self.pending = (audio * self.traffic["audio_scale"],
                        self.cams[self.i % len(self.cams)])
        self.i += 1

    def _next(self, stream):
        self._draw()
        next(stream)
        sync(self.device)

    # ---- the window ---------------------------------------------------------
    def window(self, seconds: float, spans=None) -> dict:
        stream = self._stream()
        sampler = Sampler(self.seed, self.traffic["sample"])
        sync(self.device)
        reset_peak(self.device)
        if spans is not None:
            spans.on = True
        lat, n, copied = [], 0, 0.0
        t0 = time.perf_counter()
        while True:
            self.recorder.keep = sampler.slot(n)
            self._draw()
            a = time.perf_counter()
            next(stream)
            sync(self.device)
            b = time.perf_counter()
            lat.append(b - a)
            if self.recorder.keep is not None:
                copied += to_host(self.recorder.keep)
            n += 1
            window_s = time.perf_counter() - t0 - copied
            if window_s >= seconds:
                break
        self.recorder.keep = None
        if spans is not None:
            spans.on = False
        self.stream, self.samples = stream, sampler.kept()
        return {"window_s": window_s, "latencies_s": lat, "frames": n * self.frames_per_request,
                "peak_mem_bytes": peak_bytes(self.device)}

    def run_requests(self, n: int) -> None:
        for _ in range(n):
            self._next(self.stream)

    def release(self) -> None:
        for h in self.hooks:
            h.remove()
        del self.stream, self.recorder, self.rollout, self.system
        free(self.device)
