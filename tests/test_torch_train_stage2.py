"""One stage-2 train step: the port against the JAX package, with fresh
stage-1 tokens (use_cache 0) and with the prediction-cache swap.

The tiny AudioDrivenAvatar (AvatarConfig.tiny at 32x32 with 2 output
frames, a 300-vertex synthetic SMPL-X, without the point refiner, whose
gradient tests/test_torch_train_stage1.py holds, to keep the JAX compile
short) with
numpy-seeded parameters made visible, B = 1, 2 reference frames. JAX:
`stage2.make_train_step` (one compiled program, run once per case) with an
optimizer that also records the gradients it is given
(tests/test_torch_train_stage1.py). The port: `training.stage2`'s
make_train_step on the CPU from the same weights, its Sapiens ViT returning
the JAX image tokens. The JAX side runs without remat (the same numbers,
compiled faster); the port keeps its remat on, so its checkpointed renderer
chunks and audio blocks are what is compared.

Tolerances as in tests/test_torch_train_stage1.py: loss and grad_norm 1e-4
relative, every trainable gradient leaf ||port - jax|| <= 1e-3 ||jax|| plus
the noise floor, the parameters after the update as `params_close`.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_motion_avatar_tpu.data.synthetic import make_batch as jmake_batch
from audio_motion_avatar_tpu.models.audio_avatar import AudioDrivenAvatar as JaxModel
from audio_motion_avatar_tpu.models.config import AvatarConfig as JaxConfig
from audio_motion_avatar_tpu.models.renderer import build_renderer_statics as jstatics
from audio_motion_avatar_tpu.ops import smplx as jsmplx
from audio_motion_avatar_tpu.training import stage2 as jstage2
from audio_motion_avatar_tpu.training import train_state as jts

from audio_motion_avatar_tpu_torch.data.synthetic import make_batch, to_device
from audio_motion_avatar_tpu_torch.models.audio_avatar import AudioDrivenAvatar
from audio_motion_avatar_tpu_torch.models.config import AvatarConfig
from audio_motion_avatar_tpu_torch.models.renderer import build_renderer_statics
from audio_motion_avatar_tpu_torch.ops import smplx as tsmplx
from audio_motion_avatar_tpu_torch.training import stage2
from audio_motion_avatar_tpu_torch.training.train_state import OptimConfig, TrainState
from audio_motion_avatar_tpu_torch.weights import params_from_flax
from test_torch_train_stage1 import (FAST_COMPILE, leaves_close, params_close,
                                     recording, visible)
from torch_parity import one_torch_thread, random_params  # noqa: F401

SIZE = (32, 32)
LR = 1e-3
OPTIM = dict(learning_rate=LR, total_steps=100)
CASES = ("fresh", "cached")
STAGE1_ROOTS = ("sapiens_encoder", "image_feature", "smplx_triplane_encoder",
                "fusion_network")


def _jax(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


@pytest.fixture(scope="module")
def runs():
    jcfg = dataclasses.replace(JaxConfig.tiny(image_size=SIZE), triplane_output_frames=2,
                               no_point_refiner=True, frames_scan_remat=False,
                               audio_transformer_remat=False)
    body = jsmplx.synthetic_model(seed=0, num_verts=300)
    statics = jstatics(body, subdivide_steps=jcfg.subdivide_steps,
                       densify=jcfg.densify_smplx_verts)
    nverts = 300 + np.asarray(body.faces).shape[0]
    model = JaxModel(cfg=jcfg, num_verts_encoder=nverts)
    T_in, T_out = jcfg.triplane_input_frames, jcfg.triplane_output_frames
    ref = jmake_batch(1, T_in, SIZE, seed=50)
    tgt = jmake_batch(1, T_out, SIZE, seed=51, with_audio=True, audio_dim=jcfg.audio_feature_dim)
    jref, jtgt = _jax(ref), _jax(tgt)
    params = random_params(model, 52, statics, jref.video, jref.smpl_parms, jref.cam_parms,
                           jtgt.audio_features, jtgt.cam_parms)
    visible(params["triplane_gaussian"])
    S = 3 * jcfg.triplane_resolution ** 2
    rng = np.random.RandomState(53)
    cached = {"fresh": (np.zeros((1, T_in, jcfg.triplane_feature_dim, S), np.float32),
                        np.zeros((1, T_in, jcfg.smpl_token_dim, jcfg.smpl_token_len), np.float32),
                        np.zeros(1, np.float32)),
              "cached": ((rng.randn(1, T_in, jcfg.triplane_feature_dim, S) * 0.5).astype(np.float32),
                         (rng.randn(1, T_in, jcfg.smpl_token_dim, jcfg.smpl_token_len) * 0.5
                          ).astype(np.float32),
                         np.ones(1, np.float32))}

    tx = recording(jts.make_optimizer(jts.OptimConfig(**OPTIM)))
    state0 = jts.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    step = jstage2.make_train_step(model, statics, jcfg)
    args = (jref, jtgt) + tuple(jnp.asarray(a) for a in cached["fresh"])
    compiled = step.lower(state0, *args).compile(compiler_options=FAST_COMPILE)
    tokens = jax.jit(lambda p, v: model.apply(
        {"params": p}, v, method=lambda m, x: m.triplane_gaussian.sapiens_encoder(
            x.reshape((-1,) + x.shape[2:]))))(state0.params, jref.video)
    np_ = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731

    pcfg = dataclasses.replace(AvatarConfig.tiny(image_size=SIZE), triplane_output_frames=2,
                               no_point_refiner=True)
    pbody = tsmplx.synthetic_model(seed=0, num_verts=300)
    pstatics = build_renderer_statics(pbody, "cpu", subdivide_steps=pcfg.subdivide_steps,
                                      densify=pcfg.densify_smplx_verts)
    pref = to_device(make_batch(1, T_in, SIZE, seed=50), "cpu")
    ptgt = to_device(make_batch(1, T_out, SIZE, seed=51, with_audio=True,
                                audio_dim=pcfg.audio_feature_dim), "cpu")
    flat = torch.tensor(np.asarray(tokens))
    sd = params_from_flax(np_(params))
    out = {}
    for case in CASES:
        fresh_state = jax.tree_util.tree_map(jnp.array, state0)
        new_state, metrics = compiled(fresh_state, jref, jtgt,
                                      *(jnp.asarray(a) for a in cached[case]))[:2]
        port = AudioDrivenAvatar(pcfg, nverts)
        port.load_state_dict(sd, strict=True)
        port.triplane_gaussian.sapiens_encoder.forward = lambda images: flat
        state = TrainState(port, OptimConfig(**OPTIM))
        old = {k: p.detach().clone() for k, p in port.named_parameters()}
        _, got, out_tri, *_ = stage2.make_train_step(port, pstatics, pcfg)(
            state, pref, ptgt, *(torch.tensor(a) for a in cached[case]))
        out[case] = dict(port=port, old=old, got={k: float(v) for k, v in got.items()},
                         metrics={k: float(v) for k, v in metrics.items()},
                         grads=params_from_flax(np_(new_state.opt_state[1])),
                         new=params_from_flax(np_(new_state.params)), out_tri=out_tri)
    return out


@pytest.mark.parametrize("case", CASES)
def test_loss_and_grad_norm_match(runs, case):
    r = runs[case]
    for k, v in r["metrics"].items():
        np.testing.assert_allclose(r["got"][k], v, rtol=1e-4, err_msg=k)
    want_norm = float(torch.sqrt(sum((g * g).sum() for g in r["grads"].values())))
    np.testing.assert_allclose(r["got"]["grad_norm"], want_norm, rtol=1e-4)


@pytest.mark.parametrize("case", CASES)
def test_trainable_gradients_match(runs, case):
    r = runs[case]
    got = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
           for k, p in r["port"].named_parameters() if k in r["grads"]}
    leaves_close(got, r["grads"])


@pytest.mark.parametrize("case", CASES)
def test_params_after_update_match(runs, case):
    r = runs[case]
    new = {k: p.detach() for k, p in r["port"].named_parameters()}
    params_close(new, r["grads"], r["new"], lr=LR)


def test_cache_swap_changes_the_rollout(runs):
    assert float((runs["fresh"]["out_tri"] - runs["cached"]["out_tri"]).abs().max()) > 1e-3
    assert runs["fresh"]["got"]["loss"] != runs["cached"]["got"]["loss"]


def test_no_stage1_encoder_gradient(runs):
    """Repair: the stage-1 reconstruction runs without autograd in stage 2
    (the JAX package's stop_gradient): only its shared SMPL-X decoder (used
    for the future frames) and the shared renderer get gradients."""
    port = runs["fresh"]["port"]
    for k, p in port.named_parameters():
        parts = k.split(".")
        if parts[0] == "triplane_gaussian" and parts[1] in STAGE1_ROOTS and \
                "smpl_decoder" not in parts:
            assert p.grad is None, k
    grads = {k: p.grad for k, p in port.named_parameters() if p.grad is not None}
    assert any(k.startswith("audio_triplane.") for k in grads)
    assert any(k.startswith("triplane_gaussian.renderer.") for k in grads)
    assert any("smpl_decoder" in k for k in grads)


def test_prediction_cache_matches_jax():
    """The same decisions and keys as the JAX package's PredictionCache from
    the same seed: random.Random draws against the replacement probability,
    hits on the key batch_id + 12 a step wrote, the 30-iteration bound."""
    jc, pc = jstage2.PredictionCache(0.5, seed=3), stage2.PredictionCache(0.5, seed=3)
    tri = np.random.RandomState(0).randn(1, 6, 4, 5).astype(np.float32)
    for bid in [0, 12, 24, 5, 17, 29, 12, 24, 36, 41, 53, 65]:
        ju, _, _, ji = jc.maybe_get(bid)
        pu, _, _, pi = pc.maybe_get(bid)
        assert (ju, ji) == (pu, pi), bid
        jk = jc.put(bid, tri, tri, ji)
        pk = pc.put(bid, torch.tensor(tri), torch.tensor(tri), pi)
        assert (jk is None) == (pk is None) and (jk is None or set(jk) == set(pk))
    assert set(jc.store) == set(pc.store)
    for key, item in jc.store.items():
        assert pc.store[key]["iter"] == item["iter"]
        np.testing.assert_array_equal(pc.store[key]["triplane"].numpy(), item["triplane"])
    assert stage2.PredictionCache(0.5).put(0, torch.zeros(1, 3), torch.zeros(1, 3),
                                           stage2.CACHE_MAX_ITERS) is None
    assert stage2.cache_depth_channels(0.5, 1)["l1_loss_cache_1"] == 0.5
    assert random.Random(3).random() == jstage2.PredictionCache(0.5, seed=3).rng.random()


def test_prediction_cache_keeps_entries_on_the_host():
    """Repair: put stores the step's last two frames of tokens in host memory
    (the JAX package's np.asarray), as CPU tensors equal to them and copied
    from them (a later write to the step's buffers leaves the entry as it
    was); maybe_get hands them back with the same values, on the same draws
    as the JAX cache. Stage2TrainLoop moves a hit back to the step's device."""
    rng = np.random.RandomState(1)
    tri = rng.randn(2, 6, 4, 5).astype(np.float32)
    smpl = rng.randn(2, 6, 3, 7).astype(np.float32)
    jc, pc = jstage2.PredictionCache(0.7, seed=4), stage2.PredictionCache(0.7, seed=4)
    t_tri, t_smpl = torch.tensor(tri), torch.tensor(smpl)
    assert set(jc.put(0, tri, smpl, 0)) == set(pc.put(0, t_tri, t_smpl, 0)) == {(0, 12)}
    want = {"triplane": tri[:, -2:].copy(), "smplx_tokens": smpl[:, -2:].copy()}
    t_tri.zero_()
    t_smpl.zero_()
    for name, w in want.items():
        got = pc.store[(0, 12)][name]
        assert got.device.type == "cpu" and got.dtype == torch.float32, name
        np.testing.assert_array_equal(got.numpy(), w)
        np.testing.assert_array_equal(got.numpy(), jc.store[(0, 12)][name])
    hits = 0
    for _ in range(20):
        ju, jt, js, ji = jc.maybe_get(12)
        pu, pt, ps, pi = pc.maybe_get(12)
        assert (ju, ji) == (pu, pi)
        if pu:
            hits += 1
            assert pt.device.type == "cpu" and pi == 1
            np.testing.assert_array_equal(pt.numpy(), jt)
            np.testing.assert_array_equal(ps.numpy(), js)
            np.testing.assert_array_equal(pt.numpy(), want["triplane"])
            np.testing.assert_array_equal(ps.numpy(), want["smplx_tokens"])
    assert 0 < hits < 20
