"""The IDOL reader (data/idol.AvatarDataset) and the two Pillow operations
it needs, against the JAX package's reader and PIL.

- utils/images.resize(..., "bilinear") against PIL's Image.resize((W, H),
  BILINEAR), up and down at odd sizes, RGB and L; utils/images.convert to
  "RGBA" of LA and P images (with a tRNS chunk of bytes, of one index, and
  without) against PIL's convert("RGBA"): bit for bit.
- AvatarDataset against the JAX AvatarDataset on tests/test_datasets.py's
  two fixtures (the flat layout, its 32 x 24 images resized to 32 x 32; the
  reference layout with its ring of cameras), their images replaced by
  seeded textures and, in the flat layout, some by RGBA, LA and P files with
  transparent pixels: every field of every item, bit for bit, in train mode
  with the reference view's crop augmentation (each reader draws from its
  own random.Random(0), in the same order), through the shuffled iteration,
  with better_range off and the front view jittered, in test mode with and
  without test_pose_override, and on a scene that fails (the fallback to
  scene 0). The video path is held off the codec, as the JAX tests do.
"""

import io
import os
import random
import warnings

import numpy as np
import pytest
from PIL import Image

from audio_motion_avatar_tpu.configs.loader import Config as JaxConfig
from audio_motion_avatar_tpu.data import idol as jidol

from audio_motion_avatar_tpu_torch.configs.loader import Config
from audio_motion_avatar_tpu_torch.data import idol
from audio_motion_avatar_tpu_torch.data.factory import DatasetFactory
from audio_motion_avatar_tpu_torch.utils import images
from test_datasets import make_idol_fixture, make_idol_ref_layout_fixture
from test_torch_datasets import _same_batch, _texture
from torch_parity import one_torch_thread  # noqa: F401


def _png(pil, **kw) -> bytes:
    buf = io.BytesIO()
    pil.save(buf, "PNG", **kw)
    return buf.getvalue()


def _pil_rgba(data: bytes) -> np.ndarray:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # PIL: palette transparency given as bytes
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


@pytest.mark.parametrize("size", [(20, 30), (100, 77), (64, 96), (13, 200), (57, 41)])
@pytest.mark.parametrize("channels", [3, 1])
def test_bilinear_resize_is_pils(size, channels):
    a = _texture(41, 57, 3, 2)
    img = a if channels == 3 else a[..., 0]
    want = np.asarray(Image.fromarray(img).resize(size, Image.BILINEAR))
    np.testing.assert_array_equal(images.resize(img, size, "bilinear"), want)


@pytest.mark.parametrize("mode,transparency", [("LA", None), ("P", None),
                                               ("P", bytes([0, 128, 255, 7, 0])), ("P", 3)])
def test_rgba_conversion_is_pils(mode, transparency):
    a = _texture(23, 31, 4, 5)
    pil = Image.fromarray(a[..., :2], "LA") if mode == "LA" else \
        Image.fromarray(a[..., :3]).quantize(40)
    data = _png(pil, **({} if transparency is None else {"transparency": transparency}))
    decoded = images.decode_png(data)
    assert decoded.mode == mode
    np.testing.assert_array_equal(images.convert(decoded, "RGBA"), _pil_rgba(data))


def _retexture(paths, seed, alpha_modes=()):
    """Overwrite the fixture's flat grey PNGs with seeded textures (the
    first len(alpha_modes) as RGBA, LA or P files whose top-left block is
    transparent)."""
    for i, p in enumerate(paths):
        h, w = np.asarray(Image.open(p)).shape[:2]
        a = _texture(h, w, 4, seed + i)
        a[: h // 3, : w // 3, 3] = 0
        mode = alpha_modes[i] if i < len(alpha_modes) else "RGB"
        if mode == "RGBA":
            Image.fromarray(a).save(p)
        elif mode == "LA":
            Image.fromarray(a[..., [0, 3]], "LA").save(p)
        elif mode == "P":
            q = Image.fromarray(a[..., :3]).quantize(64)
            px = np.asarray(q).copy()
            px[: h // 3, : w // 3] = 5
            out = Image.fromarray(px, "P")
            out.putpalette(q.getpalette())
            out.save(p, transparency=bytes(0 if j == 5 else 255 for j in range(64)))
        else:
            Image.fromarray(a[..., :3]).save(p)


def _flat(tmp_path):
    cache = make_idol_fixture(tmp_path)
    scenes = np.load(cache, allow_pickle=True).tolist()
    paths = [p for s in scenes for p in s["img_paths"]]
    _retexture(paths, 10, alpha_modes=("RGBA", "LA", "P"))
    return cache


def _ref_layout(tmp_path):
    cache = make_idol_ref_layout_fixture(tmp_path, n_views=12)
    scene = np.load(cache, allow_pickle=True).tolist()[0]
    param = np.load(scene["param_path"], allow_pickle=True).item()
    _retexture(param["image_paths"], 40)
    return cache


FIXTURES = {"flat": _flat, "reference layout": _ref_layout}
MODES = {
    "train, crop": dict(crop=True),
    "train, uniform views, jittered front": dict(better_range=False,
                                                  allow_k_angles_near_the_front=90, crop=True),
    "test": dict(test_mode=True),
    "test, pose override": dict(test_mode=True, test_pose_override=True, override_num_views=5),
}


def _readers(cache, extra, split="train"):
    ds = {"type": "IDOLDataset", "image_size": [32, 32], "specific_observation_num": 4,
          "first_is_front": True, "better_range": True, "cache_path_train": [cache],
          "cache_repeat": [2], **extra}
    cfg = {"dataset": ds, "training": {"batch_size": 1}}
    return idol.AvatarDataset(Config.wrap(cfg), split), \
        jidol.AvatarDataset(JaxConfig.wrap(cfg), split)


def _same_item(got, want):
    (gr, gt, gi), (wr, wt, wi) = got, want
    assert gi == wi
    _same_batch(gr, wr)
    _same_batch(gt, wt)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_items_equal_the_jax_readers(fixture, mode, tmp_path):
    port, ref = _readers(FIXTURES[fixture](tmp_path), MODES[mode])
    assert len(port) == len(ref) >= 2
    for i in list(range(len(ref))) + [1, 0]:
        _same_item(port[i], ref[i])
    for got, want in zip(port, ref):            # the shuffled epoch
        _same_item(got, want)
    assert port.rng.getstate() == ref.rng.getstate()


def test_failed_scene_falls_back_to_scene_zero(tmp_path, capsys):
    port, ref = _readers(_flat(tmp_path), {"crop": True})
    for ds in (port, ref):
        ds.scenes[1] = dict(ds.scenes[1], img_paths=["/nonexistent.png"] * 6)
    _same_item(port[1], ref[1])
    assert "falling back to scene 0" in capsys.readouterr().out


def test_video_frames_and_helpers_match_jax():
    """Off the codec: the near-white rule, the 189-d split, the front-camera
    choice, the camera ring and the augmentations on one seeded image."""
    frame = _texture(16, 20, 3, 3)
    frame[:, :4] = 252
    np.testing.assert_array_equal(idol._video_frame_white_bg(frame),
                                  jidol._video_frame_white_bg(frame))
    v = np.arange(189, dtype=np.float32)
    got, want = idol.unpack_smpl_189(v), jidol.unpack_smpl_189(v)
    assert sorted(got) == sorted(want) and all(np.array_equal(got[k], want[k]) for k in want)
    from test_datasets import _ring_poses
    poses = [(p, None) for p in _ring_poses(8)]
    for orient in ([0, 0, 0], [0, np.pi, 0], [0.3, 1.0, -0.2]):
        assert idol.find_front_camera_by_rotation(poses, np.array(orient)) == \
            jidol.find_front_camera_by_rotation(poses, np.array(orient))
    K, ring = idol.prepare_camera(640, 896, 7)
    Kj, ringj = jidol.prepare_camera(640, 896, 7)
    assert np.array_equal(K, Kj) and all(np.array_equal(a, b) for a, b in zip(ring, ringj))
    img = _texture(96, 64, 3, 4).astype(np.float32) / 255.0
    for seed in range(4):
        np.testing.assert_array_equal(idol.crop_augment_ref(img, random.Random(seed)),
                                      jidol.crop_augment_ref(img, random.Random(seed)))


def test_factory_builds_idol_with_the_shipped_config(tmp_path):
    """config_stage_1_idol.yaml's dataset section on the flat fixture, at
    the fixture's size: the factory's AvatarDataset draws as the JAX one."""
    from audio_motion_avatar_tpu.configs.loader import ConfigLoader as JaxLoader
    from audio_motion_avatar_tpu.data.factory import DatasetFactory as JaxFactory
    from audio_motion_avatar_tpu_torch.configs.loader import ConfigLoader
    cache = _flat(tmp_path)
    over = ["dataset.image_size=[32,32]", f"dataset.cache_path_train=[{cache}]",
            "dataset.cache_repeat=[1]", "training.batch_size=1"]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = DatasetFactory.create_dataset(ConfigLoader.load_config(
        os.path.join(here, "audio_motion_avatar_tpu_torch", "configs",
                     "config_stage_1_idol.yaml"), over), "train")
    ref = JaxFactory.create_dataset(JaxLoader.load_config(
        os.path.join(here, "audio_motion_avatar_tpu", "configs", "config_stage_1_idol.yaml"),
        over), "train")
    assert type(port) is idol.AvatarDataset and port.n_views == ref.n_views
    for got, want in zip(port, ref):
        _same_item(got, want)
