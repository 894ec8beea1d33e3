"""The port's CheckpointManager (training/checkpoints.py) against the JAX
package's: a save / restore round trip, the steps kept over a sequence of
saves, and a JAX checkpoint restored from orbax and converted by
params_from_flax."""

import json
import os
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from audio_motion_avatar_tpu.training import checkpoints as jax_ckpt
from audio_motion_avatar_tpu_torch.models.audio_avatar import AudioDrivenAvatar
from audio_motion_avatar_tpu_torch.models.config import AvatarConfig
from audio_motion_avatar_tpu_torch.training import checkpoints
from audio_motion_avatar_tpu_torch.training.train_state import OptimConfig, TrainState
from audio_motion_avatar_tpu_torch.weights import init_weights, params_from_flax
from torch_parity import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "demo_tiny_ckpt" / "320" / "default"


def _state(seed, accumulate=1):
    model = AudioDrivenAvatar(AvatarConfig.tiny(image_size=(32, 32)), 300 + 530)
    init_weights(model, seed)
    return TrainState(model, OptimConfig(accumulate_steps=accumulate))


def _scramble_optimizer(state, seed):
    g = torch.Generator().manual_seed(seed)
    for d in [state.opt.mu, state.opt.nu] + ([state.opt.acc] if state.opt.acc else []):
        for k in d:
            d[k] = torch.randn(d[k].shape, generator=g)
    state.opt.count, state.opt.notfinite_count, state.opt.mini_step = 7, 2, 1
    state.step = 11


@pytest.mark.parametrize("accumulate", [1, 4])
def test_round_trip_keeps_trainable_and_optimizer_drops_vit(tmp_path, accumulate):
    src = _state(0, accumulate)
    _scramble_optimizer(src, 1)
    mgr = checkpoints.CheckpointManager(str(tmp_path))
    mgr.save(5, src, metrics={"loss": 0.25})
    saved = torch.load(tmp_path / "5" / checkpoints.STATE_FILE, weights_only=True)
    assert saved["params"] and not any("sapiens_encoder" in k for k in saved["params"])
    with open(tmp_path / "5" / checkpoints.METRICS_FILE) as f:
        assert json.load(f) == {"loss": 0.25}
    assert mgr.latest_step() == 5

    dst = _state(3, accumulate)
    vit_before = {k: v.clone() for k, v in dst.model.state_dict().items()
                  if "sapiens_encoder" in k}
    dst, ok = checkpoints.CheckpointManager(str(tmp_path)).restore(dst)
    assert ok and dst.step == 11
    want = src.model.state_dict()
    for k, v in dst.model.state_dict().items():
        if "sapiens_encoder" in k:
            assert torch.equal(v, vit_before[k]), k      # the frozen ViT stays
        else:
            assert torch.equal(v, want[k]), k
    for name in ("mu", "nu") + (("acc",) if accumulate > 1 else ()):
        a, b = getattr(src.opt, name), getattr(dst.opt, name)
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert (dst.opt.count, dst.opt.notfinite_count, dst.opt.mini_step) == (7, 2, 1)


def test_restore_without_checkpoint_and_mismatch(tmp_path):
    state = _state(0)
    assert checkpoints.CheckpointManager(str(tmp_path / "empty")).restore(state)[1] is False
    checkpoints.CheckpointManager(str(tmp_path / "a")).save(1, state)
    other = TrainState(AudioDrivenAvatar(AvatarConfig.tiny(image_size=(32, 32)), None),
                       OptimConfig())
    with pytest.raises(KeyError, match="does not match"):
        checkpoints.CheckpointManager(str(tmp_path / "a")).restore(other)


SEQUENCES = {
    "min": ("loss", "min", [(1, 0.9), (2, 0.5), (3, 0.7), (4, 0.95), (5, 0.2), (6, 0.8),
                            (7, 0.99), (8, 0.3)]),
    "max": ("val/acc", "max", [(1, 0.1), (2, 0.4), (3, 0.2), (4, 0.9), (5, 0.05),
                               (6, 0.3), (7, 0.6)]),
    "fifo": (None, "min", [(s, None) for s in range(1, 8)]),
}


@pytest.mark.parametrize("which", sorted(SEQUENCES))
def test_retention_matches_jax(tmp_path, which):
    monitor, mode, saves = SEQUENCES[which]
    key = monitor.split("/")[-1] if monitor else None
    jmgr = jax_ckpt.CheckpointManager(str(tmp_path / "jax"), max_to_keep=3,
                                      monitor=monitor, mode=mode)
    pmgr = checkpoints.CheckpointManager(str(tmp_path / "port"), max_to_keep=3,
                                         monitor=monitor, mode=mode)
    jstate = SimpleNamespace(params={"w": np.zeros(2, np.float32)},
                             opt_state={"m": np.zeros(2, np.float32)}, step=np.asarray(0))
    pstate = TrainState(torch.nn.Linear(2, 1), OptimConfig())
    for step, value in saves:
        metrics = None if value is None else {key: value}
        jmgr.save(step, jstate, metrics)
        pmgr.save(step, pstate, metrics)
        assert pmgr.all_steps() == sorted(jmgr._mgr.all_steps()), step
    assert pmgr.latest_step() == jmgr.latest_step() == saves[-1][0]


def test_jax_checkpoint_converted_round_trip(tmp_path):
    """The trained fixture restored from orbax, converted by
    params_from_flax, saved and restored in the port's format: every
    trainable tensor comes back equal."""
    import orbax.checkpoint as ocp
    raw = ocp.StandardCheckpointer().restore(str(FIXTURE))
    converted = params_from_flax(jax.tree_util.tree_map(np.asarray, raw["params"]))
    from audio_motion_avatar_tpu_torch.configs import ConfigLoader
    from audio_motion_avatar_tpu_torch.configs.build import build_avatar_config
    from audio_motion_avatar_tpu_torch.ops.smplx import synthetic_model
    from audio_motion_avatar_tpu_torch.serve import num_verts_encoder
    root = Path(__file__).resolve().parents[1]
    cfg = build_avatar_config(ConfigLoader.load_config(
        str(root / "audio_motion_avatar_tpu_torch" / "configs" / "config_tiny.yaml")))
    nverts = num_verts_encoder(synthetic_model(seed=0, num_verts=400))
    model = AudioDrivenAvatar(cfg, nverts)
    model.load_state_dict(converted, strict=True)
    checkpoints.CheckpointManager(str(tmp_path)).save(320, TrainState(model, OptimConfig()))
    fresh = AudioDrivenAvatar(cfg, nverts)
    init_weights(fresh, 9)
    state, ok = checkpoints.CheckpointManager(str(tmp_path)).restore(
        TrainState(fresh, OptimConfig()))
    assert ok
    got = state.model.state_dict()
    trainable = [k for k in converted if "sapiens_encoder" not in k]
    assert len(trainable) > 100
    for k in trainable:
        assert torch.equal(got[k], converted[k]), k
    assert os.listdir(tmp_path) == ["320"]


@pytest.mark.parametrize("wrapped", [False, True], ids=["state_dict", "lightning"])
def test_reference_helpers_match_jax(tmp_path, wrapped):
    """load_torch_state_dict and import_torch_ckpt: the same numpy dicts as
    the JAX package's helpers on one torch file."""
    g = torch.Generator().manual_seed(0)
    sd = {"triplane_gaussian.renderer.w": torch.randn(3, 2, generator=g),
          "triplane_gaussian.sapiens_encoder.vit.x": torch.randn(2, generator=g),
          "triplane_gaussian.image_feature.y": torch.randn(2, generator=g),
          "audio_triplane.z": torch.randn(4, generator=g)}
    path = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": sd, "epoch": 3} if wrapped else sd, path)
    got, want = checkpoints.load_torch_state_dict(path), jax_ckpt.load_torch_state_dict(path)
    assert set(got) == set(want) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(got[k], want[k])
    for kw in ({}, {"strip_prefixes": ("audio_triplane.", "triplane_gaussian."),
                    "drop_substrings": ("renderer",)}):
        a, b = checkpoints.import_torch_ckpt(got, **kw), jax_ckpt.import_torch_ckpt(want, **kw)
        assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def test_split_and_merge_frozen():
    sd = _state(0).model.state_dict()
    train, frozen = checkpoints.split_frozen(sd)
    assert frozen and all("sapiens_encoder" in k for k in frozen)
    assert not any("sapiens_encoder" in k for k in train)
    assert checkpoints.merge_frozen(train, frozen).keys() == sd.keys()
