"""The port's data and output modules against the JAX package's:
data/synthetic (SyntheticDataset, render_gt_video), data/containers,
data/factory, ops/smplx.load_model, utils/graphics and utils/video."""

import os
import pickle
import sys

import numpy as np
import pytest

from audio_motion_avatar_tpu.configs import ConfigLoader as JaxLoader
from audio_motion_avatar_tpu.data import containers as jax_containers
from audio_motion_avatar_tpu.data import synthetic as jax_synthetic
from audio_motion_avatar_tpu.data.factory import DatasetFactory as JaxFactory
from audio_motion_avatar_tpu.utils import graphics as jax_graphics
from audio_motion_avatar_tpu.utils import video as jax_video
from audio_motion_avatar_tpu_torch.configs import ConfigLoader
from audio_motion_avatar_tpu_torch.data import containers, synthetic
from audio_motion_avatar_tpu_torch.data.factory import DatasetFactory
from audio_motion_avatar_tpu_torch.utils import graphics, video
from torch_parity import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TINY = os.path.join(ROOT, "audio_motion_avatar_tpu", "configs", "config_tiny.yaml")
PORT_TINY = os.path.join(ROOT, "audio_motion_avatar_tpu_torch", "configs", "config_tiny.yaml")


def _same_batch(got, want, video_atol=0.0):
    np.testing.assert_allclose(got.video, want.video, atol=video_atol, rtol=0)
    for name in ("smpl_parms", "cam_parms"):
        g, w = getattr(got, name), getattr(want, name)
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name}.{k}")
    if want.audio_features is None:
        assert got.audio_features is None
    else:
        np.testing.assert_array_equal(got.audio_features, want.audio_features)
    assert (got.width, got.height) == (want.width, want.height)


@pytest.mark.parametrize("index", [0, 13])
@pytest.mark.parametrize("render_gt", [False, True], ids=["noise", "render_gt"])
def test_synthetic_items_match_jax(index, render_gt):
    kw = dict(length=20, ref_frames=2, target_frames=6, image_size=(32, 48),
              with_audio=True, audio_dim=16, seed=10_000, render_gt=render_gt)
    want = jax_synthetic.SyntheticDataset(**kw)[index]
    got = synthetic.SyntheticDataset(**kw)[index]
    assert got[2] == want[2] == index
    for g, w in zip(got[:2], want[:2]):
        assert g.video.shape == w.video.shape and g.video.dtype == np.float32
        _same_batch(g, w, video_atol=1e-5 if render_gt else 0.0)
    if render_gt:   # a body, not noise: most pixels white, some not
        assert 0.05 < (got[1].video < 0.999).mean() < 0.95


def test_render_gt_video_matches_jax_batched():
    """B = 2 batches of 3 frames on the tiny body."""
    from audio_motion_avatar_tpu.ops import smplx as jax_smplx
    from audio_motion_avatar_tpu_torch.ops import smplx
    batch = jax_synthetic.make_batch(2, 3, (32, 32), seed=4)
    want = jax_synthetic.render_gt_video(jax_smplx.synthetic_model(seed=0, num_verts=400),
                                         batch, (32, 32))
    port_batch = synthetic.make_batch(2, 3, (32, 32), seed=4)
    got = synthetic.render_gt_video(smplx.synthetic_model(seed=0, num_verts=400),
                                    port_batch, (32, 32))
    assert got.shape == want.shape == (2, 3, 3, 32, 32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _items(module, n=5):
    ds = module.SyntheticDataset(length=n, image_size=(8, 8), with_audio=True, audio_dim=4)
    return [ds[i] for i in range(n)]


def test_collate_matches_jax():
    got = containers.collate_video_batches([r for r, _, _ in _items(synthetic)])
    want = jax_containers.collate_video_batches([r for r, _, _ in _items(jax_synthetic)])
    assert got.video.shape == (5, 2, 3, 8, 8)
    _same_batch(got, want)


def test_collated_batches_group_and_drop_the_tail():
    items = _items(synthetic)
    got = list(containers.CollatedBatches(items, 2))
    want = list(jax_containers.CollatedBatches(_items(jax_synthetic), 2))
    assert len(got) == len(want) == len(containers.CollatedBatches(items, 2)) == 2
    for (gr, gt, gi), (wr, wt, wi) in zip(got, want):
        assert gi == wi
        _same_batch(gr, wr)
        _same_batch(gt, wt)


def test_collate_refuses_partial_optional_fields():
    _, a, _ = _items(synthetic, 1)[0]
    with pytest.raises(ValueError, match="only some"):
        containers.collate_video_batches([a, a._replace(audio_features=None)])


@pytest.mark.parametrize("split", ["train", "val"])
def test_factory_synthetic_matches_jax(split):
    over = ["dataset.length=3", "training.batch_size=2"]
    want = JaxFactory.create_dataset(JaxLoader.load_config(JAX_TINY, over), split)
    got = DatasetFactory.create_dataset(ConfigLoader.load_config(PORT_TINY, over), split)
    assert type(got).__name__ == "SyntheticDataset" and len(got) == len(want) == 3
    assert (got.seed, got.kw, got.with_audio, got.audio_dim, got.render_gt) == \
        (want.seed, want.kw, want.with_audio, want.audio_dim, want.render_gt)
    for g, w in zip(got[2][:2], want[2][:2]):
        _same_batch(g, w)
    loader = DatasetFactory.create_dataloader(ConfigLoader.load_config(PORT_TINY, over), split)
    assert loader.length == 3


@pytest.mark.parametrize("kind", ["IDOLDataset"])
def test_factory_refuses_unported_datasets(kind):
    cfg = ConfigLoader.load_config(PORT_TINY, [f"dataset.type={kind}"])
    with pytest.raises(NotImplementedError, match="item 6"):
        DatasetFactory.create_dataset(cfg, "val")


@pytest.mark.parametrize("kind", ["ThumanDataset", "GaussianAudioDataset"])
def test_factory_builds_the_ported_readers(kind, tmp_path):
    """The two readers come from the factory; their B = 1 items are grouped
    by training.batch_size on the train split."""
    import warnings

    from test_datasets import make_speech_fixture, make_thuman_fixture
    root = str(tmp_path / "data")
    if kind == "ThumanDataset":
        make_thuman_fixture(root)
        over = [f"dataset.dataset_root={root}", f"dataset.smplx_params_path={root}/smplx"]
    else:
        make_speech_fixture(root)
        over = [f"dataset.root_dir={root}", "dataset.clip_length=4"]
    cfg = ConfigLoader.load_config(PORT_TINY, [f"dataset.type={kind}", "training.batch_size=2",
                                               "dataset.image_size=[32,32]", *over])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the untrained audio fallback
        assert type(DatasetFactory.create_dataset(cfg, "val", "cpu")).__name__ == kind
        loader = DatasetFactory.create_dataloader(cfg, "train", "cpu")
    assert isinstance(loader, containers.CollatedBatches) and loader.batch_size == 2
    ref, _, _ = next(iter(loader))
    assert ref.video.shape[:1] == (2,) and ref.video.shape[-2:] == (32, 32)


def test_factory_refuses_unknown_type_and_workers():
    with pytest.raises(ValueError, match="Unknown dataset type"):
        DatasetFactory.create_dataset(ConfigLoader.load_config(PORT_TINY, ["dataset.type=X"]))
    cfg = ConfigLoader.load_config(PORT_TINY, ["training.dataloader.num_workers=2"])
    with pytest.raises(NotImplementedError, match="prefetch"):
        DatasetFactory.create_dataloader(cfg, "train")
    assert len(DatasetFactory.create_dataloader(cfg, "val")) == 8


def _release(num_verts=30, shape_components=400):
    """A file with the released SMPL-X layout (random values)."""
    rng = np.random.RandomState(0)
    parents = np.arange(-1, 54)
    parents[1:] = rng.randint(0, np.arange(1, 55))
    return {"v_template": rng.randn(num_verts, 3),
            "shapedirs": rng.randn(num_verts, 3, shape_components),
            "posedirs": rng.randn(num_verts, 3, 54 * 9 + 9),
            "kintree_table": np.stack([np.concatenate([[4294967295], parents[1:]]),
                                       np.arange(55)]),
            "J_regressor": rng.rand(57, num_verts), "weights": rng.rand(num_verts, 57),
            "hands_meanl": rng.randn(45), "hands_meanr": rng.randn(45),
            "f": rng.randint(0, num_verts, (40, 3)), "name": "SMPLX_NEUTRAL"}


@pytest.mark.parametrize("form", ["npz", "pkl", "dir", "short_shapedirs"])
def test_load_model_matches_jax(tmp_path, form):
    from audio_motion_avatar_tpu.ops import smplx as jax_smplx
    from audio_motion_avatar_tpu_torch.ops import smplx
    data = _release(shape_components=20 if form == "short_shapedirs" else 400)
    if form == "pkl":
        path = str(tmp_path / "SMPLX_NEUTRAL.pkl")
        with open(path, "wb") as f:
            pickle.dump(data, f)
    else:
        path = str(tmp_path / "SMPLX_NEUTRAL.npz")
        np.savez(path, **{k: v for k, v in data.items() if k != "name"})
    if form == "dir":
        path = str(tmp_path)
    want = jax_smplx.load_model(path, num_expr=10)
    got = smplx.load_model(path, num_expr=10)
    for name in got._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)), err_msg=name)
        assert isinstance(getattr(got, name), np.ndarray)


def _mesh(seed=0):
    """A small closed-ish mesh in front of an orbiting camera."""
    rng = np.random.RandomState(seed)
    v = rng.randn(60, 3) * np.array([0.25, 0.6, 0.15])
    faces = rng.randint(0, 60, (90, 3)).astype(np.int32)
    K, E = jax_synthetic.orbit_camera(0.4, image_size=(48, 40), focal=60.0)
    image = rng.rand(48, 40, 3).astype(np.float32)
    return image, v.astype(np.float32), faces, K, E


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_overlay_bit_equal_to_jax(seed):
    image, v, faces, K, E = _mesh(seed)
    transl = np.array([0.05, -0.1, 0.02], np.float32)
    want = jax_graphics.draw_smplx_on_image(image, v, faces, K, E, transl=transl)
    got = graphics.draw_smplx_on_image(image, v, faces, K, E, transl=transl)
    np.testing.assert_array_equal(got, want)
    assert (got != image).any()
    np.testing.assert_array_equal(
        graphics.rasterize_mesh_overlay(image, v, faces, K, E, alpha=0.3),
        jax_graphics.rasterize_mesh_overlay(image, v, faces, K, E, alpha=0.3))


def test_triplane_pca_equal_to_jax():
    planes = np.random.RandomState(3).randn(3, 8, 6, 5).astype(np.float32)
    np.testing.assert_array_equal(graphics.visualize_triplane_pca(planes),
                                  jax_graphics.visualize_triplane_pca(planes))


def test_png_pixels_equal_jax_writer(tmp_path):
    """The stdlib PNG encoder against PIL's files from the JAX writer, both
    decoded by PIL; values outside [0, 1] clip the same."""
    from PIL import Image
    rng = np.random.RandomState(4)
    frames = [rng.rand(17, 23, 3).astype(np.float32) * 1.2 - 0.1 for _ in range(3)]
    video.write_frames(frames, str(tmp_path / "port"))
    jax_video.write_frames(frames, str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == \
        ["frame_00000.png", "frame_00001.png", "frame_00002.png"]
    for n in names:
        got = Image.open(tmp_path / "port" / n)
        assert got.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(got),
                                      np.asarray(Image.open(tmp_path / "jax" / n)))
        np.testing.assert_array_equal(video.read_png(str(tmp_path / "port" / n)),
                                      np.asarray(got))


def test_mp4_written_with_cv2_and_skipped_without(tmp_path, monkeypatch, capsys):
    frames = [np.full((16, 16, 3), i / 4, np.float32) for i in range(4)]
    path = video.write_mp4(frames, str(tmp_path / "a.mp4"), fps=24)
    assert path == str(tmp_path / "a.mp4") and os.path.getsize(path) > 0
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert video.write_mp4(frames, str(tmp_path / "b.mp4")) is None
    assert not (tmp_path / "b.mp4").exists()
    assert "skipped" in capsys.readouterr().out


def test_to_device_keeps_the_batch():
    ref, _, _ = _items(synthetic, 1)[0]
    t = synthetic.to_device(ref, "cpu")
    assert t.video.dtype.is_floating_point and (t.width, t.height) == (8, 8)
    np.testing.assert_array_equal(t.cam_parms["extrinsic"].numpy(), ref.cam_parms["extrinsic"])
    np.testing.assert_array_equal(t.video.numpy(), ref.video)
