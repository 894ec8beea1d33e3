"""The TED speech-video dataset (stage-2 training) and its speech track
(the JAX package's data/speech.py).

The clip layout:

    <root_dir>/imgs_png/%05d.png         frames
    <root_dir>/samurai_seg/%05d.png      masks (grey)
    <root_dir>/smplx_params/%05d.json    per-frame SMPL-X (betas, trans,
                                         root_pose, body_pose, lhand_pose,
                                         rhand_pose, jaw_pose, leye_pose,
                                         reye_pose, focal, princpt)
    <root_dir>/*.wav|*.mp3               speech track

An item is a window of 2 clip_length frames at stride 2 starting at frame
2 idx: each frame composited on white through its mask, scaled to uint8 by
truncation, resized to dataset.image_size (Pillow's bicubic,
utils/images.py); ref = the window's frames [0, 1], target = its last
clip_length - 2 frames with their audio features; K from focal and
princpt, E the identity. The audio features are computed once, at init,
by models/audio_encoder.AudioFeatureExtractor on the dataset's device.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import subprocess
import wave

import numpy as np

from ..utils.images import read_png, resize
from .containers import VideoBatch


def load_audio(path: str) -> tuple[np.ndarray, int]:
    """Decode a speech track to (mono float32 waveform, sample rate).

    A .wav decodes with the standard library (sample widths 1, 2 and 4
    bytes; channels averaged); anything else (mp3, m4a, ...) through an
    `ffmpeg` subprocess at 16 kHz. Without a decoder this raises rather
    than substituting silent (all-zero) audio features."""
    if path.lower().endswith(".wav"):
        with wave.open(path, "rb") as wf:
            sr = wf.getframerate()
            width = wf.getsampwidth()
            raw = wf.readframes(wf.getnframes())
            if width == 2:
                wav = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
            elif width == 1:
                wav = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
            elif width == 4:
                wav = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
            else:
                raise RuntimeError(f"unsupported wav sample width {width}")
            if wf.getnchannels() > 1:
                wav = wav.reshape(-1, wf.getnchannels()).mean(-1)
        return wav, sr
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(
            f"cannot decode {path!r}: ffmpeg is not on PATH and only .wav "
            "decodes natively. Install ffmpeg or convert the clip to wav; "
            "silent (all-zero) audio features are not substituted.")
    sr = 16000
    proc = subprocess.run(
        [ffmpeg, "-v", "error", "-i", path, "-f", "s16le", "-acodec",
         "pcm_s16le", "-ac", "1", "-ar", str(sr), "-"],
        capture_output=True)
    if proc.returncode != 0 or not proc.stdout:
        raise RuntimeError(
            f"ffmpeg failed to decode {path!r}: "
            f"{proc.stderr.decode(errors='replace')[:500]}")
    wav = np.frombuffer(proc.stdout, np.int16).astype(np.float32) / 32768.0
    return wav, sr


def write_wav(path: str, wav: np.ndarray, sample_rate: int = 16000) -> None:
    """A mono float waveform in [-1, 1] as a 16-bit PCM wav."""
    pcm = np.clip(np.round(np.asarray(wav, np.float64) * 32767.0), -32768, 32767)
    with wave.open(path, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(int(sample_rate))
        wf.writeframes(pcm.astype("<i2").tobytes())


def load_rgb_on_white(img_path: str, mask_path: str) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1]: the frame composited on white through
    its grey mask where the mask exists."""
    img = read_png(img_path, "RGB").astype(np.float32) / 255.0
    if os.path.exists(mask_path):
        m = read_png(mask_path, "L").astype(np.float32) / 255.0
        img = img * m[..., None] + (1.0 - m[..., None])
    return img


class GaussianAudioDataset:
    def __init__(self, cfg, split: str = "train", device=None):
        """device: where the audio features are computed (CUDA unless
        "cpu" is asked for); the items are numpy either way."""
        ds = cfg.dataset
        root = ds.get("root_dir")
        if not root or not os.path.isdir(str(root)):
            raise FileNotFoundError(
                f"TED speech root_dir not found: {root!r}. Configure "
                "dataset.root_dir or use the synthetic dataset.")
        self.root = str(root)
        self.image_size = tuple(ds.image_size)
        self.clip_length = int(ds.get("clip_length", 8))
        self.frame_rate = float(ds.get("frame_rate", 24))
        self.num_expr = int(ds.get("num_expression_coeffs", 10))
        self.audio_dim = int(ds.get("audio_feature_dim", 768))

        self.image_files = sorted(glob.glob(os.path.join(self.root, "imgs_png", "*.png")))
        if not self.image_files:
            raise FileNotFoundError(f"no frames in {self.root}/imgs_png")

        from ..models.audio_encoder import (SAMPLE_RATE, AudioFeatureExtractor,
                                            resample_linear)
        wavs = (glob.glob(os.path.join(self.root, "*.wav"))
                + glob.glob(os.path.join(self.root, "*.mp3")))
        n_frames = len(self.image_files)
        extractor = AudioFeatureExtractor(model_path=ds.get("wav2vec2_model_path"),
                                          dim=self.audio_dim, device=device)
        if wavs:
            # a wav first (decoded here); an mp3 needs ffmpeg or raises
            wavs.sort(key=lambda p: (not p.lower().endswith(".wav"), p))
            raw, sr = load_audio(wavs[0])
            wav = resample_linear(raw, sr)
        else:
            wav = np.zeros(int(n_frames / self.frame_rate * SAMPLE_RATE), np.float32)
        self.audio_features = extractor.features_per_video_frame(
            wav, n_frames, self.frame_rate, self.clip_length)
        self.audio_path = wavs[0] if wavs else None

    def __len__(self):
        return max(0, (len(self.image_files) - 2 * self.clip_length) // 2 + 1)

    def _frame_id(self, i):
        return os.path.splitext(os.path.basename(self.image_files[i]))[0]

    def _load_smplx(self, i):
        path = os.path.join(self.root, "smplx_params", f"{int(self._frame_id(i)):05d}.json")
        with open(path) as f:
            p = json.load(f)

        def arr(key, n):
            v = np.asarray(p.get(key, np.zeros(n)), np.float32).reshape(-1)
            out = np.zeros(n, np.float32)
            out[: min(n, v.size)] = v[:n]
            return out

        params = {
            "betas": arr("betas", 10),
            "transl": arr("trans", 3),
            "global_orient": arr("root_pose", 3),
            "body_pose": arr("body_pose", 63),
            "left_hand_pose": arr("lhand_pose", 45),
            "right_hand_pose": arr("rhand_pose", 45),
            "jaw_pose": arr("jaw_pose", 3),
            "leye_pose": arr("leye_pose", 3),
            "reye_pose": arr("reye_pose", 3),
            "expression": arr("expression", self.num_expr),
        }
        return params, arr("focal", 2), arr("princpt", 2)

    def _load_frame(self, i):
        mask = os.path.join(self.root, "samurai_seg", f"{int(self._frame_id(i)):05d}.png")
        img = load_rgb_on_white(self.image_files[i], mask)
        H, W = self.image_size
        img = resize((img * 255).astype(np.uint8), (W, H)).astype(np.float32) / 255.0
        return img.transpose(2, 0, 1)

    def __getitem__(self, idx):
        start = idx * 2
        frame_ids = list(range(start, start + 2 * self.clip_length, 2))
        videos, smpls, Ks, Es, afs = [], [], [], [], []
        for i in frame_ids:
            params, focal, princpt = self._load_smplx(i)
            videos.append(self._load_frame(i))
            smpls.append(params)
            Ks.append(np.array([[focal[0], 0, princpt[0]], [0, focal[1], princpt[1]],
                                [0, 0, 1]], np.float32))
            Es.append(np.eye(4, dtype=np.float32))
            afs.append(self.audio_features[min(i, len(self.audio_features) - 1)])

        def build(sel, with_audio=False):
            return VideoBatch(
                video=np.stack([videos[j] for j in sel])[None],
                smpl_parms={k: np.stack([smpls[j][k] for j in sel])[None] for k in smpls[0]},
                cam_parms={"intrinsic": np.stack([Ks[j] for j in sel])[None],
                           "extrinsic": np.stack([Es[j] for j in sel])[None]},
                width=self.image_size[1], height=self.image_size[0],
                audio_features=np.stack([afs[j] for j in sel])[None] if with_audio else None)

        n = len(frame_ids)
        ref = build([0, 1])
        target = build(list(range(n - (self.clip_length - 2), n)), with_audio=True)
        return ref, target, idx

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
