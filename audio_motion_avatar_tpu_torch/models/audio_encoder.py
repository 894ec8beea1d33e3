"""Audio features: speech waveform -> one feature vector a video frame (the
JAX package's models/audio_encoder.py).

Resample to 16 kHz, trim or pad to the video's duration, encode it one
clip window at a time, mean-pool the encoder states within each video
frame's span. The encoder is the port's Wav2Vec2 (models/wav2vec2.py) when
a local wav2vec2-base-960h checkout is configured, else an untrained conv
stack with the same output geometry, with a warning: that is a fallback
for missing data (its features are noise), not for a missing device. The
extractor runs on the card unless it is given device="cpu", in fp32 with
TF32 off.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import fp32_geometry, resolve_device
from ..weights import init_weights

AUDIO_DIM = 768
SAMPLE_RATE = 16000


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Pad the last axis as an XLA 'SAME' convolution does: ceil(L / s)
    outputs, the padding's smaller half before."""
    L = x.shape[-1]
    total = max((math.ceil(L / s) - 1) * s + k - L, 0)
    return F.pad(x, (total // 2, total - total // 2))


class ConvAudioEncoder(nn.Module):
    """Fallback waveform encoder: strided conv stack ('SAME' padding, GELU
    after each) -> ~49 Hz frames of `dim` features, Wav2Vec2's output
    geometry without its transformer."""

    LAYERS = ((64, 10, 5), (128, 3, 2), (256, 3, 2), (256, 3, 2),
              (512, 3, 2), (512, 2, 2))

    def __init__(self, dim: int = AUDIO_DIM):
        super().__init__()
        spec = self.LAYERS + ((dim, 2, 2),)
        c_in = 1
        self.spec = []
        for i, (ch, k, s) in enumerate(spec):
            setattr(self, f"conv{i}", nn.Conv1d(c_in, ch, k, stride=s))
            self.spec.append((k, s))
            c_in = ch

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """wav (B, T_samples) -> (B, T_frames, dim); ~320x downsampling."""
        x = wav[:, None]
        for i, (k, s) in enumerate(self.spec):
            x = F.gelu(getattr(self, f"conv{i}")(_same_pad(x, k, s)))
        return x.transpose(1, 2)


class AudioFeatureExtractor:
    """Host-callable extractor with per-video-frame pooling."""

    def __init__(self, model_path: Optional[str] = None, dim: int = AUDIO_DIM,
                 seed: int = 0, device=None):
        self.dim = dim
        self.device = resolve_device(device)
        self._normalize = None
        if model_path and os.path.exists(str(model_path)):
            from .wav2vec2 import load_wav2vec2, zero_mean_unit_var
            self.encoder, do_normalize = load_wav2vec2(str(model_path), self.device)
            self._normalize = zero_mean_unit_var if do_normalize else None
        else:
            warnings.warn(
                "AudioFeatureExtractor: no Wav2Vec2 weights at "
                f"{model_path!r} — using the UNTRAINED conv fallback. "
                "Features are random-projection noise; stage-2 runs "
                "mechanically but learns nothing meaningful from audio. "
                "Set dataset.wav2vec2_model_path to a local "
                "facebook/wav2vec2-base-960h checkout for real features.",
                stacklevel=2)
            self.encoder = ConvAudioEncoder(dim=dim)
            init_weights(self.encoder, seed)
            self.encoder.to(self.device).eval()

    @torch.no_grad()
    def encode_window(self, wav: np.ndarray) -> np.ndarray:
        """wav (T_samples,) float32 at 16 kHz -> (T_enc, dim) hidden states;
        with a checkout, the processor's normalization of the window first."""
        if self._normalize is not None:
            wav = self._normalize(wav)
        x = torch.as_tensor(np.asarray(wav, np.float32), device=self.device)[None]
        with fp32_geometry():
            out = self.encoder(x)
        return out[0].float().cpu().numpy()

    def features_per_video_frame(self, wav: np.ndarray, num_frames: int,
                                 frame_rate: float = 24.0,
                                 clip_length: int = 8) -> np.ndarray:
        """Trim or pad the wave to the video's duration, encode it in
        clip_length-frame windows, mean-pool the encoder states within each
        frame's span -> (num_frames, dim). Pooling follows the reference's
        floor semantics: steps_per_frame = max(1, T_enc // frames_in_clip);
        frame i pools [i spf, (i + 1) spf) clamped to T_enc (one step if the
        span is empty); a short tail repeats the last feature."""
        need = int(round(num_frames / frame_rate * SAMPLE_RATE))
        wav = np.asarray(wav, np.float32)
        if wav.shape[0] < need:
            wav = np.pad(wav, (0, need - wav.shape[0]))
        wav = wav[:need]

        samples_per_clip = int(round(clip_length / frame_rate * SAMPLE_RATE))
        feats = []
        for start_f in range(0, num_frames, clip_length):
            nf = min(clip_length, num_frames - start_f)
            s0 = int(round(start_f / frame_rate * SAMPLE_RATE))
            clip = wav[s0: s0 + samples_per_clip]
            if clip.shape[0] < samples_per_clip:
                clip = np.pad(clip, (0, samples_per_clip - clip.shape[0]))
            hidden = self.encode_window(clip)  # (T_enc, dim)
            T_enc = hidden.shape[0]
            spf = max(1, T_enc // nf)
            for f in range(nf):
                a = min(f * spf, T_enc - 1)
                b = min((f + 1) * spf, T_enc)
                feats.append(hidden[a:b].mean(axis=0) if a < b else hidden[a])
        if len(feats) < num_frames:
            feats.extend([feats[-1]] * (num_frames - len(feats)))
        return np.stack(feats[:num_frames], axis=0)


def resample_linear(wav: np.ndarray, sr_in: int, sr_out: int = SAMPLE_RATE) -> np.ndarray:
    """Linear resampling on the host (for feature preparation)."""
    if sr_in == sr_out:
        return np.asarray(wav, np.float32)
    n_out = int(round(len(wav) * sr_out / sr_in))
    x_old = np.linspace(0.0, 1.0, num=len(wav), endpoint=False)
    x_new = np.linspace(0.0, 1.0, num=n_out, endpoint=False)
    return np.interp(x_new, x_old, np.asarray(wav, np.float64)).astype(np.float32)
