"""Speech tracks (the JAX package's data/speech.py, `load_audio` only; the
TED speech-video dataset is not ported yet)."""

from __future__ import annotations

import shutil
import subprocess
import wave

import numpy as np


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
