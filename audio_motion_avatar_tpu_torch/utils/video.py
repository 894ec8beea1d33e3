"""Video output on the host (the JAX package's utils/video.py): frame PNGs
and an mp4 with the speech track muxed in.

`write_frames` encodes 8-bit RGB PNGs with the standard library (zlib,
struct), so it needs neither PIL nor cv2 (`read_png` reads them back). `write_mp4` needs cv2 (imported
when called): without it the mp4 is skipped with one printed line, as the
JAX package keeps a silent video when ffmpeg is missing; the frames are
written all the same.
"""

from __future__ import annotations

import os
import struct
import subprocess
import zlib
from typing import Optional, Sequence

import numpy as np


def to_uint8(frame) -> np.ndarray:
    """(H, W, 3) float in [0, 1] -> uint8, as the JAX writer rounds."""
    return np.clip(np.asarray(frame) * 255, 0, 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> the bytes of an 8-bit RGB PNG (no row filters)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """An 8-bit RGB PNG written by encode_png (no row filters) -> (H, W, 3)
    uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, size = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            size = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    w, h, depth, colour = size[:4]
    if (depth, colour) != (8, 2):
        raise ValueError(f"{path}: not 8-bit RGB")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: row filters are not supported")
    return rows[:, 1:].reshape(h, w, 3)


def write_frames(frames: Sequence[np.ndarray], out_dir: str, prefix: str = "frame"):
    os.makedirs(out_dir, exist_ok=True)
    for i, f in enumerate(frames):
        with open(os.path.join(out_dir, f"{prefix}_{i:05d}.png"), "wb") as fh:
            fh.write(encode_png(to_uint8(f)))


def write_mp4(frames: Sequence[np.ndarray], path: str, fps: int = 24,
              audio_path: Optional[str] = None) -> Optional[str]:
    """frames: list of (H, W, 3) float in [0, 1] -> an mp4 at `path` (with
    the audio muxed by ffmpeg when given and available). Returns the path,
    or None when cv2 is missing and the mp4 was skipped."""
    try:
        import cv2
    except ImportError:
        print(f"[video] cv2 is not installed: skipped {path} "
              f"({len(frames)} frames; the PNG frames are written)")
        return None
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    h, w = np.asarray(frames[0]).shape[:2]
    tmp = path if audio_path is None else path + ".noaudio.mp4"
    writer = cv2.VideoWriter(tmp, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        writer.write(cv2.cvtColor(to_uint8(f), cv2.COLOR_RGB2BGR))
    writer.release()

    if audio_path is not None:
        try:
            subprocess.run(
                ["ffmpeg", "-y", "-i", tmp, "-i", audio_path, "-c:v", "copy",
                 "-c:a", "aac", "-shortest", path],
                check=True, capture_output=True)
            os.remove(tmp)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            print(f"[video] ffmpeg mux failed ({e}); keeping silent video")
            os.replace(tmp, path)
    return path
