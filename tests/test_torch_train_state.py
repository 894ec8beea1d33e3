"""The port's optimizer and train state against the JAX package's optax
chain (training/train_state.py), on seeded gradient sequences.

Each sequence feeds both the same numpy gradients for a small parameter
tree: ordinary steps, a step whose global norm is far above the clip, a
non-finite step (skipped and counted by apply_if_finite), with and without
MultiSteps accumulation and the linear warmup. After every step the
parameters agree to 1e-6 (both float32; the clip's norm and Adam's bias
correction are summed and powered in another order). Also: the frozen
split, and the refusal of forward-only render options at build time.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
import optax

from audio_motion_avatar_tpu.training import train_state as jts

from audio_motion_avatar_tpu_torch.models.config import AvatarConfig, serving_config
from audio_motion_avatar_tpu_torch.training import train_state as tts

SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}


def grad_sequence(seed, n, nan_at=(), big_at=()):
    rng = np.random.RandomState(seed)
    seq = []
    for i in range(n):
        g = {k: (rng.randn(*s) * 0.05).astype(np.float32) for k, s in SHAPES.items()}
        if i in big_at:
            g = {k: v * 400.0 for k, v in g.items()}
        if i in nan_at:
            g["b"][1] = np.nan
        seq.append(g)
    return seq


CASES = {
    "plain": (dict(learning_rate=1e-2, total_steps=10), dict(n=6, nan_at=(2,), big_at=(1, 4))),
    "warmup": (dict(learning_rate=1e-2, total_steps=10, warmup_steps=3, end_factor=0.1),
               dict(n=7, big_at=(0,))),
    "accumulate": (dict(learning_rate=1e-2, total_steps=8, accumulate_steps=2, warmup_steps=2),
                   dict(n=8, big_at=(3,))),
    "accumulate_nan": (dict(learning_rate=1e-2, total_steps=8, accumulate_steps=2),
                       dict(n=6, nan_at=(3,))),
    "nan_limit": (dict(learning_rate=1e-2, total_steps=10, nan_guard_max_consecutive=1),
                  dict(n=5, nan_at=(1, 2, 3))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_optax(case):
    cfg_kw, seq_kw = CASES[case]
    rng = np.random.RandomState(7)
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    tx = jts.make_optimizer(jts.OptimConfig(**cfg_kw))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = tx.init(jp)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    opt = tts.Optimizer(tts.OptimConfig(**cfg_kw), tp)
    for i, g in enumerate(grad_sequence(11, **seq_kw)):
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt.apply({k: torch.tensor(v) for k, v in g.items()}, tp)
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6,
                                       equal_nan=True, err_msg=f"{case} step {i} {k}")
    assert any(not np.array_equal(tp[k].numpy(), p0[k]) for k in SHAPES)


def test_learning_rate_schedule_matches_optax():
    cfg = dict(learning_rate=3e-3, total_steps=20, warmup_steps=4, end_factor=0.05)
    jcfg = jts.OptimConfig(**cfg)
    decay = optax.linear_schedule(jcfg.learning_rate, jcfg.learning_rate * jcfg.end_factor,
                                  jcfg.total_steps - jcfg.warmup_steps)
    sched = optax.join_schedules([optax.linear_schedule(0.0, jcfg.learning_rate, 4), decay], [4])
    for count in range(25):
        assert float(tts.learning_rate(tts.OptimConfig(**cfg), count)) == \
            float(np.float32(sched(count))), count


class _Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.sapiens_encoder = nn.Linear(3, 2)
        self.renderer = nn.Linear(2, 2)


def test_frozen_split_matches_jax():
    """The Sapiens encoder's parameters carry no optimizer state and never
    move, in both packages; the rest trains."""
    model = _Toy()
    state = tts.TrainState(model, tts.OptimConfig(learning_rate=0.1))
    assert set(state.trainable) == {"renderer.weight", "renderer.bias"}
    assert set(state.frozen) == {"sapiens_encoder.weight", "sapiens_encoder.bias"}
    assert set(state.opt.mu) == set(state.trainable)
    params = {"sapiens_encoder": {"kernel": jnp.ones((3, 2))},
              "renderer": {"kernel": jnp.ones((2, 2))}}
    train, frozen = jts.split_frozen(params)
    assert set(train) == {"renderer"} and set(frozen) == {"sapiens_encoder"}
    before = model.sapiens_encoder.weight.detach().clone()
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    assert state.apply_gradients()
    assert torch.equal(model.sapiens_encoder.weight, before)
    assert not torch.equal(model.renderer.weight, torch.zeros(2, 2))
    assert tts.is_frozen("triplane_gaussian.sapiens_encoder.vit.block_0.mlp1.weight")


@pytest.mark.parametrize("knob", ["splat_segmented", "upsampler_sparse", "sample_quad",
                                  "sample_quad_dense"])
def test_training_refuses_only_the_segmented_splat(knob):
    """Repair: the segmented splat (kernel S) has no backward; building a
    train step with it raises and names the option. The sparse upsampler
    trains by autograd with the 4-tap sampler and with the quad sampler
    (kernel Q, its backward Q-bwd), and sample_quad on the dense path is
    ignored as the JAX renderer ignores it: the steps and the trainer build,
    the renderer keeping the knobs (the 4-tap form's first step against JAX:
    tests/test_torch_render_forms.py; the quad form's:
    tests/test_torch_quad_train.py)."""
    from audio_motion_avatar_tpu_torch.train import build_trainer
    from audio_motion_avatar_tpu_torch.training import stage1, stage2
    knobs = {"sample_quad": dict(sample_quad=True, upsampler_sparse=True),
             "sample_quad_dense": dict(sample_quad=True)}.get(knob, {knob: True})
    cfg = dataclasses.replace(AvatarConfig.tiny(image_size=(32, 32)), **knobs)
    if knob != "splat_segmented":
        for make in (stage1.make_train_step, stage2.make_train_step):
            make(None, None, cfg)
        tr = build_trainer(2, cfg, device="cpu")
        rcfg = tr.model.renderer.cfg
        assert rcfg.upsampler_sparse == (knob in ("upsampler_sparse", "sample_quad"))
        assert rcfg.sample_quad == (knob in ("sample_quad", "sample_quad_dense"))
        return
    for make in (stage1.make_train_step, stage2.make_train_step):
        with pytest.raises(ValueError, match=knob):
            make(None, None, cfg)
    with pytest.raises(ValueError, match=knob):
        build_trainer(2, cfg, device="cpu")
    with pytest.raises(ValueError, match="splat_segmented"):
        build_trainer(1, serving_config(AvatarConfig.tiny(image_size=(32, 32))), device="cpu")


def test_build_trainer_without_a_card_raises():
    """No fallback: with no device named, the trainer wants CUDA."""
    from audio_motion_avatar_tpu_torch.train import build_trainer
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_trainer(1, AvatarConfig.tiny(image_size=(32, 32)))
