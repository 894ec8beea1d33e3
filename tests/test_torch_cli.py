"""The port's training and evaluation CLIs on the CPU: main --mode
train|test|predict and main2 --mode train|test, and the config.yaml they
write.

- config.yaml: on every shipped YAML with overrides, `yaml.safe_load` of the
  port's file equals the JAX config's to_dict(), the port's own loader
  reads it back equal, and the file is byte for byte the one the JAX
  setup_output_dirs writes.
- main on config_tiny.yaml with a THuman-layout fixture (tests/
  test_datasets.py's layout, textured 40^2 renders read at 32^2):
  fast_dev_run train writes the comparison PNG and config.yaml (no event
  files or checkpoints, as the JAX Trainer); a full epoch writes event
  files and a checkpoint kept by the monitored metric, and test from that
  checkpoint gives the fit's final validation metrics (the same weights and
  val split: within 1e-6 relative, float32 event values); predict writes
  the test comparison PNGs.
- main2 on config_tiny.yaml with a TED-layout fixture: fast_dev_run train
  writes what tests/test_stage2_observability.py asks of the JAX run (event
  files, audio_comparison_<step>_iter<depth>.png, ref_comparison_<step>.png);
  test writes predict_results/audio_comparison_<n>.png and the mean L1.
- Without --device cpu, every mode asks for the card and raises here; a
  checkpoint file (item 4) and parallel or multi-host runs (item 7) raise.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from audio_motion_avatar_tpu.configs.loader import ConfigLoader as JaxLoader

from audio_motion_avatar_tpu_torch import main, main2
from audio_motion_avatar_tpu_torch.configs import yaml_subset
from audio_motion_avatar_tpu_torch.configs.loader import ConfigLoader
from audio_motion_avatar_tpu_torch.training.trainer import read_scalars
from test_datasets import make_speech_fixture, make_thuman_fixture
from torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT_CONFIGS = ROOT / "audio_motion_avatar_tpu_torch" / "configs"
JAX_CONFIGS = ROOT / "audio_motion_avatar_tpu" / "configs"
TINY = str(PORT_CONFIGS / "config_tiny.yaml")
OVERRIDES = ["training.learning_rate=1e-4", "dataset.image_size=[48,40]",
             "model.compute_dtype=bfloat16", "training.logging.use_wandb=yes",
             "model.renderer.note='a: b'", "training.tag=null", "seed=0x1f"]


def _texture(h, w, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)


# ---------------------------------------------------------------------------
# config.yaml
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(p.name for p in PORT_CONFIGS.glob("config_*.yaml")))
def test_config_yaml_matches_jax(name, tmp_path):
    from audio_motion_avatar_tpu import main as jmain
    over = OVERRIDES + [f"training.output_dir={tmp_path / 'out'}"]
    jcfg = JaxLoader.load_config(str(JAX_CONFIGS / name), over)
    cfg = ConfigLoader.load_config(str(PORT_CONFIGS / name), over)
    jmain.setup_output_dirs(jcfg)
    want = (tmp_path / "out" / "config.yaml").read_text()
    (tmp_path / "out" / "config.yaml").unlink()
    main.setup_output_dirs(cfg)
    got = (tmp_path / "out" / "config.yaml").read_text()
    assert yaml.safe_load(got) == jcfg.to_dict()
    assert yaml_subset.loads(got) == cfg.to_dict()
    assert got == want


# ---------------------------------------------------------------------------
# main: stage 1
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def thuman(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("thuman") / "thuman")
    make_thuman_fixture(root)
    for i, subj in enumerate(["0001", "0002"]):
        for v in range(4):
            Image.fromarray(_texture(40, 40, 10 * i + v)).save(
                os.path.join(root, subj, "12views_3", "render", f"{v:03d}.png"))
    return root


def _stage1(thuman, out, *extra):
    return ["--device", "cpu", "--config", TINY, f"training.output_dir={out}",
            "dataset.type=ThumanDataset", f"dataset.dataset_root={thuman}",
            f"dataset.smplx_params_path={thuman}/smplx", "dataset.image_size=[32,32]",
            "dataset.n_test=3", "dataset.pcd_nums=50", *extra]


def test_main_fast_dev_run(thuman, tmp_path, capsys):
    out = tmp_path / "fast"
    assert main.main(["--mode", "train", *_stage1(thuman, out)]) is None
    log = capsys.readouterr().out
    assert "[e0 s0] l1_train=" in log and "step_time_s=" in log and "lr=" in log
    assert (out / "train_images" / "comparison_0.png").exists()
    assert yaml_subset.load(str(out / "config.yaml"))["dataset"]["type"] == "ThumanDataset"
    assert not (out / "tb").exists() and os.listdir(out / "checkpoints") == []
    metrics = main.main(["--mode", "test", *_stage1(thuman, out)])
    assert np.isfinite(metrics["loss"]) and metrics["loss_total"] == metrics["loss"]
    assert (out / "test_images" / "triplane_comparison_0.png").exists()


def test_main_train_checkpoint_then_test(thuman, tmp_path):
    """One epoch (2 subjects, AdamW, an update a step), validation,
    the monitored checkpoint; test from it reproduces the validation."""
    out = tmp_path / "run"
    run = _stage1(thuman, out, "training.fast_dev_run=false", "training.max_epochs=1",
                  "training.logging.log_every_n_steps=1", "training.optimizer.weight_decay=0.01",
                  "training.gradient_accumulate_steps=1")
    main.main(["--mode", "train", *run])
    ckpts = os.listdir(out / "checkpoints")
    assert ckpts == ["2"]
    (events,) = (out / "tb").iterdir()
    scalars = read_scalars(str(events))
    train = [(s, t) for s, t, _ in scalars if t == "train/loss"]
    assert train == [(0, "train/loss"), (1, "train/loss")]
    val = {t[4:]: v for s, t, v in scalars if t.startswith("val/")}
    metrics = main.main(["--mode", "test", "--checkpoint", str(out / "checkpoints"), *run])
    assert sorted(metrics) == sorted(val)
    for k, v in val.items():
        assert abs(metrics[k] - v) <= 1e-6 * max(abs(v), 1.0), (k, metrics[k], v)
    # a fresh model without the checkpoint evaluates elsewhere
    fresh = main.main(["--mode", "predict", *run])
    assert fresh["loss"] != metrics["loss"]
    assert len(os.listdir(out / "test_images")) == 2


# ---------------------------------------------------------------------------
# main2: stage 2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ted(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ted") / "ted")
    make_speech_fixture(root, n_frames=18)
    for i in range(18):
        Image.fromarray(_texture(48, 40, i)).save(os.path.join(root, "imgs_png", f"{i:05d}.png"))
    return root


def _stage2(ted, out, *extra):
    return ["--device", "cpu", "--config", TINY, f"training.output_dir={out}",
            "dataset.type=GaussianAudioDataset", f"dataset.root_dir={ted}",
            "dataset.image_size=[32,32]", "dataset.clip_length=8", *extra]


def test_main2_fast_dev_run_writes_tb_and_images(ted, tmp_path, capsys):
    out = tmp_path / "out"
    with pytest.warns(UserWarning, match="UNTRAINED"):
        summary = main2.main(["--mode", "train", *_stage2(ted, out),
                              "training.cache_replacement_prob=0.5"])
    assert len(summary["steps"]) == 1 and summary["steps"][0]["cache_iter"] == 0
    assert np.isfinite(summary["steps"][0]["metrics"]["loss"])
    assert "l1_loss_no_cache=" in capsys.readouterr().out
    (events,) = (out / "tb").glob("events.out.tfevents.*")
    tags = {t for _, t, _ in read_scalars(str(events))}
    assert {"train/loss", "train/grad_norm", "train/l1_loss_no_cache",
            "train/l1_loss_cache_1"} <= tags
    assert (out / "audio_rendered_images" / "audio_comparison_0_iter0.png").exists()
    assert (out / "audio_rendered_images" / "ref_comparison_0.png").exists()
    assert not (out / "checkpoints").exists()


def test_main2_test_writes_predictions(ted, tmp_path, capsys):
    out = tmp_path / "out"
    with pytest.warns(UserWarning, match="UNTRAINED"):
        res = main2.main(["--mode", "test", *_stage2(ted, out)])
    assert res["batches"] == 2 and np.isfinite(res["l1"])
    assert f"test l1={res['l1']:.5f} over 2 batches" in capsys.readouterr().out
    assert sorted(os.listdir(out / "predict_results")) == ["audio_comparison_0.png",
                                                          "audio_comparison_1.png"]


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cli,mode", [(main, "train"), (main, "test"), (main, "predict"),
                                      (main2, "train"), (main2, "test")])
def test_cli_defaults_to_the_card(cli, mode, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert cli.parse_args(["--mode", mode]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--config", TINY, "--mode", mode, f"training.output_dir={tmp_path}"])


@pytest.mark.parametrize("extra,match", [
    (["--checkpoint", __file__], "item 4"),
    (["training.devices=2"], "item 7"),
    (["training.model_parallel=2"], "item 7"),
    (["training.multihost=true"], "item 7"),
])
def test_main_refusals_name_the_roadmap_item(extra, match, tmp_path):
    with pytest.raises(NotImplementedError, match=match):
        main.main(["--device", "cpu", "--config", TINY, "--mode", "train",
                   f"training.output_dir={tmp_path}", *extra])
