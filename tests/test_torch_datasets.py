"""The port's host image path and dataset readers against PIL and the JAX
package's readers.

- utils/images.decode_png + convert against PIL's Image.open(...).convert,
  bit for bit, on PNGs PIL writes (adaptive row filters, with and without
  optimize: every filter type occurs) of every colour type (L, LA, RGB,
  RGBA, P; grey and palette also below 8 bits), to "RGB" and to "L";
  encode_png's grey and RGB files under each filter type read back by PIL.
- utils/images.resize against PIL's Image.resize((W, H)) (bicubic), bit for
  bit, up and down, at odd sizes, RGB and L, and a same-size copy.
- data/thuman.ThumanDataset and data/speech.GaussianAudioDataset against
  the JAX readers on the layouts tests/test_datasets.py writes, their images
  replaced by seeded textured ones at a size that forces a resize (the
  masks grey ramps with noise): every field of ref and target, the ids,
  pcd_points, the audio features (a seeded tiny Wav2Vec2 checkout: within
  1e-4, the extractors' own bound in tests/test_torch_audio.py; everything
  else equal), the shuffled iteration order and the factory's
  CollatedBatches grouping at batch size 2.
"""

import io
import os
import zlib

import numpy as np
import pytest
from PIL import Image

from audio_motion_avatar_tpu.configs.loader import Config as JaxConfig
from audio_motion_avatar_tpu.data.factory import DatasetFactory as JaxFactory

from audio_motion_avatar_tpu_torch.configs.loader import Config
from audio_motion_avatar_tpu_torch.data.factory import DatasetFactory
from audio_motion_avatar_tpu_torch.utils import images
from test_datasets import make_speech_fixture, make_thuman_fixture
from torch_parity import one_torch_thread  # noqa: F401


def _texture(h, w, c, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(x / (3.0 + k) + seed) * 60 + np.cos(y / (4.0 + k)) * 50 + 120
                     for k in range(c)], -1)
    return np.clip(base + rng.randint(-25, 25, (h, w, c)), 0, 255).astype(np.uint8)


def _pil_png(img: Image.Image, optimize: bool = False) -> bytes:
    """PIL's PNG: adaptive row filters, Average among them only with
    optimize (Pillow's ZipEncode.c)."""
    buf = io.BytesIO()
    img.save(buf, "PNG", optimize=optimize)
    return buf.getvalue()


def _row_filters(data: bytes, bpp: int, width: int) -> set:
    pos, idat = 8, b""
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = zlib.decompress(idat)
    return set(raw[::1 + bpp * width])


PIL_IMAGES = {
    "L": lambda a: Image.fromarray(a[..., 0]),
    "LA": lambda a: Image.fromarray(a[..., :2], "LA"),
    "RGB": lambda a: Image.fromarray(a[..., :3]),
    "RGBA": lambda a: Image.fromarray(a),
    "P": lambda a: Image.fromarray(a[..., :3]).quantize(180),
}


def test_pil_pngs_use_every_row_filter():
    seen = set()
    for i, (mode, make) in enumerate(PIL_IMAGES.items()):
        bpp = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "P": 1}[mode]
        for optimize in (False, True):
            seen |= _row_filters(_pil_png(make(_texture(41, 57, 4, i)), optimize), bpp, 57)
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("mode", sorted(PIL_IMAGES))
@pytest.mark.parametrize("to", ["RGB", "L"])
def test_decode_matches_pil(mode, to):
    for seed, (h, w) in enumerate([(41, 57), (1, 9), (17, 1), (64, 33)] * 2):
        data = _pil_png(PIL_IMAGES[mode](_texture(h, w, 4, seed)), optimize=seed >= 4)
        img = images.decode_png(data)
        assert img.mode == mode
        want = np.asarray(Image.open(io.BytesIO(data)).convert(to))
        got = images.convert(img, to)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("filter_type", range(5))
def test_encode_png_read_by_pil(filter_type, tmp_path):
    rgb = _texture(23, 31, 3, filter_type)
    for img, mode in ((rgb, "RGB"), (rgb[..., 1], "L")):
        data = images.encode_png(img, filter_type)
        pil = Image.open(io.BytesIO(data))
        assert pil.mode == mode
        np.testing.assert_array_equal(np.asarray(pil), img)
        np.testing.assert_array_equal(images.decode_png(data).pixels, img)
        path = tmp_path / f"{mode}.png"
        path.write_bytes(data)
        np.testing.assert_array_equal(images.read_png(str(path), mode), img)


def test_decode_refuses_what_it_cannot_read():
    bad = bytearray(images.encode_png(_texture(4, 4, 3, 0)))
    bad[30] ^= 1
    with pytest.raises(ValueError, match="CRC"):
        images.decode_png(bytes(bad))
    with pytest.raises(ValueError, match="not a PNG"):
        images.decode_png(b"GIF89a")
    sixteen = _pil_png(Image.fromarray(_texture(8, 8, 1, 0)[..., 0].astype(np.uint16) * 257))
    with pytest.raises(ValueError, match="bit depth 16"):
        images.decode_png(sixteen)


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_decode_packed_grey_and_palette_match_pil(bits):
    """Grey and palette PNGs below 8 bits (PIL writes a palette image with
    few colours at 1, 2 or 4 bits with optimize, and "1" images at 1 bit)."""
    tex = _texture(13, 21, 3, bits)
    cases = [_pil_png(Image.fromarray(tex).quantize(2 ** bits), optimize=True)]
    if bits == 1:
        cases.append(_pil_png(Image.fromarray(tex[..., 0]).convert("1")))
    for data in cases:
        assert data[24] == bits     # IHDR bit depth
        for to in ("RGB", "L"):
            np.testing.assert_array_equal(images.convert(images.decode_png(data), to),
                                          np.asarray(Image.open(io.BytesIO(data)).convert(to)))


RESIZES = [((45, 37), (26, 30)), ((37, 45), (80, 61)), ((101, 77), (77, 101)),
           ((64, 64), (64, 33)), ((33, 64), (64, 33)), ((300, 200), (7, 5)),
           ((48, 40), (52, 36)), ((9, 13), (13, 9)), ((5, 7), (2000, 3))]


@pytest.mark.parametrize("src,size", RESIZES)
def test_resize_matches_pil(src, size):
    h, w = src
    rgb = _texture(h, w, 3, h * w)
    for img in (rgb, rgb[..., 2]):
        want = np.asarray(Image.fromarray(img).resize(size))
        got = images.resize(img, size)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_resize_same_size_is_a_copy():
    img = _texture(12, 10, 3, 1)
    out = images.resize(img, (10, 12))
    np.testing.assert_array_equal(out, img)
    assert out is not img


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

def _cfgs(ds, batch_size=1):
    tree = {"dataset": ds, "training": {"batch_size": batch_size}}
    return JaxConfig.wrap(tree), Config.wrap(tree)


def _same_batch(got, want):
    np.testing.assert_array_equal(got.video, want.video)
    assert got.video.dtype == want.video.dtype == np.float32
    for name in ("smpl_parms", "cam_parms"):
        g, w = getattr(got, name), getattr(want, name)
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name}.{k}")
    assert (got.width, got.height) == (want.width, want.height)
    for name in ("pcd_points", "cropped_images"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if w is not None:
            np.testing.assert_array_equal(g, w)


def _same_items(got, want, audio_tol=0.0):
    assert len(got) == len(want)
    for (gr, gt, gi), (wr, wt, wi) in zip(got, want):
        assert gi == wi
        _same_batch(gr, wr)
        _same_batch(gt, wt)
        if wt.audio_features is None:
            assert gt.audio_features is None
        else:
            np.testing.assert_allclose(gt.audio_features, wt.audio_features,
                                       atol=audio_tol, rtol=0)
        assert gr.audio_features is None and wr.audio_features is None


@pytest.fixture(scope="module")
def thuman(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("thuman") / "thuman")
    make_thuman_fixture(root)
    for i, subj in enumerate(["0001", "0002"]):
        render = os.path.join(root, subj, "12views_3", "render")
        for v in range(4):
            Image.fromarray(_texture(45, 37, 3, 10 * i + v)).save(
                os.path.join(render, f"{v:03d}.png"), optimize=v % 2 == 1)
    with open(os.path.join(root, "val.txt"), "w") as f:
        f.write("0002\n")
    return root


def test_thuman_matches_jax(thuman):
    from audio_motion_avatar_tpu.data.thuman import ThumanDataset as JaxThuman
    from audio_motion_avatar_tpu_torch.data.thuman import ThumanDataset
    ds = {"image_size": [30, 26], "n_test": 3, "pcd_nums": 50, "num_expression_coeffs": 10,
          "dataset_root": thuman, "smplx_params_path": os.path.join(thuman, "smplx"),
          "val_list": os.path.join(thuman, "val.txt")}
    jcfg, cfg = _cfgs(ds)
    for split, n in (("train", 2), ("val", 1)):
        want, got = JaxThuman(jcfg, split), ThumanDataset(cfg, split)
        assert len(got) == len(want) == n
        # item access, then the shuffled iteration, drawing from one rng each
        _same_items([got[i] for i in range(n)] + list(got) + [got[0]],
                    [want[i] for i in range(n)] + list(want) + [want[0]])
    ref = got[0][0]
    assert ref.video.shape == (1, 1, 3, 30, 26) and ref.pcd_points.shape == (1, 50, 3)


def test_thuman_collated_batches_match_jax(thuman):
    ds = {"type": "ThumanDataset", "image_size": [45, 37], "n_test": 4, "pcd_nums": 20,
          "num_expression_coeffs": 10, "dataset_root": thuman,
          "smplx_params_path": os.path.join(thuman, "smplx")}
    jcfg, cfg = _cfgs(ds, batch_size=2)
    want = list(JaxFactory.create_dataloader(jcfg, "train"))
    got = list(DatasetFactory.create_dataloader(cfg, "train"))
    assert len(got) == 1 and got[0][0].video.shape == (2, 1, 3, 45, 37)
    _same_items(got, want)


@pytest.fixture(scope="module")
def ted(tmp_path_factory):
    import torch
    from transformers import Wav2Vec2Config, Wav2Vec2Model
    base = tmp_path_factory.mktemp("ted")
    root = str(base / "ted")
    make_speech_fixture(root, n_frames=22)
    rng = np.random.RandomState(4)
    for i in range(22):
        Image.fromarray(_texture(48, 40, 3, i)).save(
            os.path.join(root, "imgs_png", f"{i:05d}.png"))
        ramp = np.linspace(0, 255, 40)[None] * np.ones((48, 1)) + rng.randint(-40, 40, (48, 40))
        Image.fromarray(np.clip(ramp, 0, 255).astype(np.uint8)).save(
            os.path.join(root, "samurai_seg", f"{i:05d}.png"))
    os.remove(os.path.join(root, "samurai_seg", "00004.png"))   # a frame without a mask
    torch.manual_seed(0)
    hf = Wav2Vec2Model(Wav2Vec2Config(
        hidden_size=24, num_hidden_layers=1, num_attention_heads=2, intermediate_size=48,
        conv_dim=(8,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
        conv_stride=(5, 2, 2, 2, 2, 2, 2), num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, conv_bias=False, do_stable_layer_norm=False,
        feat_extract_norm="group", vocab_size=32)).eval()
    hf.save_pretrained(str(base / "w2v"))
    return root, str(base / "w2v")


def _ted_cfg(root, w2v):
    return {"type": "GaussianAudioDataset", "image_size": [36, 52], "clip_length": 4,
            "frame_rate": 24, "num_expression_coeffs": 10, "audio_feature_dim": 24,
            "root_dir": root, "wav2vec2_model_path": w2v}


def test_speech_matches_jax(ted):
    from audio_motion_avatar_tpu.data.speech import GaussianAudioDataset as JaxSpeech
    from audio_motion_avatar_tpu_torch.data.speech import GaussianAudioDataset
    jcfg, cfg = _cfgs(_ted_cfg(*ted))
    want, got = JaxSpeech(jcfg, "train"), GaussianAudioDataset(cfg, "train", device="cpu")
    assert len(got) == len(want) == 8
    np.testing.assert_allclose(got.audio_features, want.audio_features, atol=1e-4, rtol=0)
    assert got.audio_features.shape == (22, 24)
    _same_items(list(got), list(want), audio_tol=1e-4)
    ref, target, _ = got[1]
    assert ref.video.shape == (1, 2, 3, 36, 52) and target.video.shape == (1, 2, 3, 36, 52)


def test_speech_collated_batches_match_jax(ted):
    jcfg, cfg = _cfgs(_ted_cfg(*ted), batch_size=3)
    want = list(JaxFactory.create_dataloader(jcfg, "train"))
    got = list(DatasetFactory.create_dataloader(cfg, "train", "cpu"))
    assert [i for _, _, i in got] == [0, 3] and got[0][1].audio_features.shape == (3, 2, 24)
    _same_items(got, want, audio_tol=1e-4)


def test_speech_mp3_without_a_decoder_raises(tmp_path, monkeypatch):
    from audio_motion_avatar_tpu_torch.data import speech
    root = str(tmp_path / "ted")
    make_speech_fixture(root, n_frames=8)
    os.remove(os.path.join(root, "speech.wav"))
    open(os.path.join(root, "speech.mp3"), "wb").close()
    monkeypatch.setattr(speech.shutil, "which", lambda name: None)
    _, cfg = _cfgs(_ted_cfg(root, None))
    with pytest.warns(UserWarning, match="UNTRAINED"), pytest.raises(RuntimeError, match="ffmpeg"):
        speech.GaussianAudioDataset(cfg, "train", device="cpu")
