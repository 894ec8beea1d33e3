"""Images on the host without PIL: PNG decode and encode, Pillow's mode
conversions and its default resize.

The JAX package reads every dataset image with PIL (`Image.open(path)
.convert("RGB")`, masks `.convert("L")`, `Image.resize((W, H))`); the
machines the port runs on need not have PIL, so this module computes the
same pixels itself:

- `decode_png` / `read_png`: PNGs that are not interlaced, of every colour
  type at 8 bits (grey, grey + alpha, RGB, RGBA, palette; grey and palette
  also at 1, 2 and 4 bits, grey scaled to 8 bits as Pillow unpacks it) and
  every row filter
  (None, Sub, Up, Average, Paeth). Average and Paeth take the pixel to the
  left, so a row is sequential along x; the rows are undone together along
  the image's anti-diagonals (pixel (r, x) needs (r, x - 1), (r - 1, x) and
  (r - 1, x - 1), all on earlier diagonals), each diagonal one vector step
  over its pixels and their bytes.
- `convert`: Pillow's "RGB" and "L" conversions (L is ITU-R 601-2 luma in
  Pillow's fixed point, (R 19595 + G 38470 + B 7471 + 0x8000) >> 16; a
  palette image converts through its palette; alpha is dropped).
- `resize`: `Image.resize((W, H))` with its default filter, bicubic
  (a = -0.5), as Pillow's libImaging/Resample.c computes it: the support
  widened by the downscale factor, the coefficients normalised and fixed to
  22 fractional bits (rounded away from zero), a horizontal pass clipped to
  uint8 and then a vertical one; a same-size resize is a copy. The passes
  sum in int32, as the C code does.
- `encode_png`: grey (H, W) or RGB (H, W, 3) uint8, every row with one
  filter type (None by default).
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import NamedTuple, Optional, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> (Pillow mode, bytes a pixel at 8 bits)
_COLOUR = {0: ("L", 1), 2: ("RGB", 3), 3: ("P", 1), 4: ("LA", 2), 6: ("RGBA", 4)}
PRECISION_BITS = 22     # Resample.c: 32 - 8 - 2


class PngImage(NamedTuple):
    pixels: np.ndarray                  # (H, W) for L and P, else (H, W, C) uint8
    mode: str                           # "L", "LA", "RGB", "RGBA" or "P"
    palette: Optional[np.ndarray] = None    # (N, 3) uint8 for mode P


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(data: np.ndarray, types: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters: data (H, W, bpp) filtered bytes, types (H,) ->
    (H, W, bpp) uint8."""
    h, w, _ = data.shape
    if types.size and int(types.max()) > 4:
        raise ValueError(f"PNG: unknown row filter {int(types.max())}")
    f = data.astype(np.int16)
    if not np.isin(types, (3, 4)).any():
        # no row needs its left neighbour's result: row by row
        out = np.zeros((h, w, bpp), np.int16)
        prior = np.zeros((w, bpp), np.int16)
        for r in range(h):
            row, kind = f[r], types[r]
            if kind == 1:
                row = np.cumsum(row, axis=0, dtype=np.int64)
            elif kind == 2:
                row = row + prior
            prior = out[r] = row & 255
        return out.astype(np.uint8)
    # skewed: diagonal t = r + x is S[t + 2, r + 1] (two zero diagonals and
    # a zero row first), so its neighbours are slices of the two before it
    F = np.zeros((h + w - 1, h, bpp), np.int16)
    for r in range(h):
        F[r:r + w, r] = f[r]
    S = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    masks = [(types == k)[:, None] for k in (1, 2, 3, 4)]
    for t in range(h + w - 1):
        r0, r1 = max(0, t - w + 1), min(h - 1, t) + 1
        a, b, c = S[t + 1, r0 + 1:r1 + 1], S[t + 1, r0:r1], S[t, r0:r1]
        m1, m2, m3, m4 = (m[r0:r1] for m in masks)
        pred = np.where(m1, a, np.where(m2, b, np.where(
            m3, (a + b) >> 1, np.where(m4, _paeth(a, b, c), 0))))
        S[t + 2, r0 + 1:r1 + 1] = (F[t, r0:r1] + pred) & 255
    out = np.empty((h, w, bpp), np.uint8)
    for r in range(h):
        out[r] = S[r + 2:r + 2 + w, r + 1]
    return out


def _unpack(rows: np.ndarray, depth: int, w: int) -> np.ndarray:
    """(H, row bytes) of `depth`-bit samples, most significant first ->
    (H, W) sample values."""
    per = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[..., None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(rows.shape[0], rows.shape[1] * per)[:, :w].astype(np.uint8)


def decode_png(data: bytes) -> PngImage:
    """The pixels of a non-interlaced PNG (8-bit, or 1-, 2- or 4-bit grey
    and palette images)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, header, palette = 8, [], None, None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG: bad CRC in {kind!r}")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR")
    w, h, depth, colour, _, _, interlace = header
    packed = depth in (1, 2, 4) and colour in (0, 3)
    if not (depth == 8 or packed) or colour not in _COLOUR or interlace:
        raise ValueError(f"PNG: only 8-bit (or 1-, 2-, 4-bit grey and palette), "
                         f"non-interlaced images are read (bit depth {depth}, colour "
                         f"type {colour}, interlace {interlace})")
    mode, bpp = _COLOUR[colour]
    if mode == "P" and palette is None:
        raise ValueError("PNG: palette image without PLTE")
    width = (w * depth + 7) // 8 if packed else w      # filter units a row
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows[:h * (1 + width * bpp)].reshape(h, 1 + width * bpp)
    pixels = _unfilter(rows[:, 1:].reshape(h, width, bpp), rows[:, 0], bpp)
    if packed:
        pixels = _unpack(pixels[..., 0], depth, w)
        if mode == "L":
            pixels = pixels * np.uint8(255 // ((1 << depth) - 1))
        return PngImage(pixels, mode, palette if mode == "P" else None)
    return PngImage(pixels[..., 0] if bpp == 1 else pixels, mode,
                    palette if mode == "P" else None)


def _luma(rgb: np.ndarray) -> np.ndarray:
    """Pillow's L24: ITU-R 601-2 luma in 16-bit fixed point."""
    v = rgb.astype(np.uint32)
    return ((v[..., 0] * 19595 + v[..., 1] * 38470 + v[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def convert(img: PngImage, mode: str) -> np.ndarray:
    """Pillow's Image.convert(mode) for mode "RGB" -> (H, W, 3) or "L" ->
    (H, W) uint8."""
    px = img.pixels
    if img.mode == "P":
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(img.palette)] = img.palette[:256]
        rgb = pal[px]
    elif img.mode in ("L", "LA"):
        grey = px if img.mode == "L" else px[..., 0]
        if mode == "L":
            return grey.copy()
        rgb = np.repeat(grey[..., None], 3, axis=-1)
    else:
        rgb = px[..., :3]
    if mode == "RGB":
        return np.ascontiguousarray(rgb)
    if mode == "L":
        return _luma(rgb)
    raise ValueError(f"convert: mode {mode!r} (RGB or L)")


def read_png(path: str, mode: str = "RGB") -> np.ndarray:
    """Image.open(path).convert(mode) for a PNG: (H, W, 3) or (H, W) uint8."""
    with open(path, "rb") as f:
        return convert(decode_png(f.read()), mode)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _filter(img: np.ndarray, kind: int) -> np.ndarray:
    """Every row of (H, W, bpp) uint8 filtered with filter type `kind`."""
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pred = {0: 0, 1: a, 2: b, 3: (a + b) >> 1, 4: _paeth(a, b, c)}[kind]
    return ((x - pred) & 255).astype(np.uint8)


def encode_png(img: np.ndarray, filter_type: int = 0) -> bytes:
    """(H, W) grey or (H, W, 3) RGB uint8 -> the bytes of an 8-bit PNG whose
    rows all use `filter_type` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        colour, px = 0, img[..., None]
    elif img.ndim == 3 and img.shape[2] == 3:
        colour, px = 2, img
    else:
        raise ValueError(f"encode_png takes (H, W) or (H, W, 3) uint8, got {img.shape}")
    if filter_type not in range(5):
        raise ValueError(f"filter_type {filter_type} (0-4)")
    h, w, bpp = px.shape
    body = _filter(px, filter_type).reshape(h, w * bpp)
    rows = np.concatenate([np.full((h, 1), filter_type, np.uint8), body], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------

def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coefficients(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Resample.c's precompute_coeffs + normalize_coeffs_8bpc for the
    bicubic filter over the whole axis: (first input index (out,), fixed
    point weights (out, ksize) int64, zero past each window)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    j = np.arange(ksize)
    w = _bicubic(((j[None] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(j[None] < xmax[:, None], w, 0.0)
    total = np.zeros(out_size)
    for i in range(ksize):      # summed in order, as the C loop does
        total = total + w[:, i]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    scaled = w * float(1 << PRECISION_BITS)
    fixed = np.trunc(np.where(w < 0, scaled - 0.5, scaled + 0.5)).astype(np.int64)
    return xmin, fixed


def _pass(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One 8-bit resampling pass along `axis` of a uint8 array, in int32 as
    Resample.c sums (|sum| < 255 * 1.3 * 2^22 < 2^31)."""
    n = img.shape[axis]
    first, k = _coefficients(n, out_size)
    src = np.ascontiguousarray(np.moveaxis(img, axis, 0))
    k = k.astype(np.int32)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int32)
    bcast = (slice(None),) + (None,) * (src.ndim - 1)
    for i in range(k.shape[1]):
        acc += src[np.minimum(first + i, n - 1)] * k[:, i][bcast]
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Pillow's Image.resize(size) (size = (W, H), bicubic) of an (H, W) or
    (H, W, C) uint8 image."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize takes uint8 images, got {img.dtype}")
    w_out, h_out = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    out = img
    if w_out != w:
        out = _pass(out, 1, w_out)
    if h_out != h:
        out = _pass(out, 0, h_out)
    return out.copy() if out is img else out
