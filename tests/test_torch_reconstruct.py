"""The stage-1 reconstruction end to end: the JAX package vs the port.

1. The tiny TriplaneGaussianAvatar (AvatarConfig.tiny, 64x64, a 300-vertex
   synthetic SMPL-X; its default render form: dense upsampler with the
   poly up-convolution and GroupNorm, dense bilinear sampling, the tile
   splat) with numpy-seeded parameters: every AvatarOutput field, the
   novel views and the `stage1_loss` metrics, through
   `reconstruct.build_reconstructor`. On the CPU the JAX renderer
   composites through its 'tiles' route, the port through K1's plain
   version: the same binning and blend.
2. The trained tiny stage-2 fixture (tests/fixtures/demo_tiny_ckpt/320),
   restored over the seeded state by the JAX package's own
   CheckpointManager as main2.py does, loaded into the port: the stage-1
   pass plus one rollout against AudioDrivenAvatar.apply.

Both models run the Sapiens ViT in bf16 (the JAX package's default, as
the reference's autocast), and the two frameworks round bf16 at different
places, so the image tokens differ by bf16 noise, which everything after
them amplifies. So the port runs twice: once as it is, and its image
tokens are held to 2x the JAX bf16 tokens' own distance from an fp32 run;
once with its ViT's output replaced by the JAX image tokens, and every
later output (fp32 on both sides) is held tightly. Tolerances: tokens,
gaussians and params 1e-4 absolute (reassociated fp32 matmuls, the SMPL-X
chain); frames mean |diff| <= 1e-3 and not blank; metrics 1e-4 relative.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_motion_avatar_tpu.data.synthetic import make_batch as jmake_batch
from audio_motion_avatar_tpu.models.avatar import TriplaneGaussianAvatar as JaxAvatar
from audio_motion_avatar_tpu.models.config import AvatarConfig as JaxConfig
from audio_motion_avatar_tpu.models.ptv3 import build_point_refiner as jbuild_refiner
from audio_motion_avatar_tpu.models.renderer import build_renderer_statics as jstatics
from audio_motion_avatar_tpu.ops import smplx as jsmplx
from audio_motion_avatar_tpu.ops.splat import render_multi_view as jrender_multi_view
from audio_motion_avatar_tpu.training.stage1 import stage1_loss as jstage1_loss

from audio_motion_avatar_tpu_torch.data.synthetic import make_batch, to_device
from audio_motion_avatar_tpu_torch.models.config import AvatarConfig
from audio_motion_avatar_tpu_torch.ops import smplx as tsmplx
from audio_motion_avatar_tpu_torch.reconstruct import build_reconstructor
from audio_motion_avatar_tpu_torch.training.stage1 import make_render_fn
from audio_motion_avatar_tpu_torch.weights import params_from_flax
from test_torch_train_stage1 import FAST_COMPILE
from torch_parity import one_torch_thread, random_params  # noqa: F401

FIXTURE = Path(__file__).parent / "fixtures" / "demo_tiny_ckpt"
CONFIG = Path(__file__).resolve().parents[1] / "audio_motion_avatar_tpu" / "configs" / "config_tiny.yaml"


def _jax(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


def jitted(fn, *args):
    """fn(*args) compiled by XLA's CPU backend at its lowest optimisation
    level (op by op the JAX model takes several times longer)."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)


def _perturb(params, rng):
    """Visible gaussians: larger scale and opacity biases, small offsets."""
    r = params["renderer"]
    r["scaling_layer"]["bias"] = np.full(3, 1.5, np.float32)
    r["opacity_layer"]["bias"] = np.full(1, 2.0, np.float32)
    for name in ("xyz_layer", "rotation_layer", "scaling_layer", "opacity_layer", "shs_layer"):
        r[name]["kernel"] = (r[name]["kernel"] * 0.1).astype(np.float32)
    r["refine_mlp"]["layers_4"]["kernel"] *= 0.01
    return params


def _noise_bounded(got, want, want32):
    diff, noise = np.abs(got - want), np.abs(want - want32)
    return diff.mean() <= 2 * noise.mean() and diff.max() <= 2 * noise.max()


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxConfig.tiny()
    jmodel = jsmplx.synthetic_model(seed=0, num_verts=300)
    statics = jstatics(jmodel, subdivide_steps=jcfg.subdivide_steps,
                       densify=jcfg.densify_smplx_verts)
    nverts = 300 + np.asarray(jmodel.faces).shape[0]
    model = JaxAvatar(cfg=jcfg, num_verts_encoder=nverts, point_refiner=jbuild_refiner(jcfg))
    ref = jmake_batch(1, 2, jcfg.image_size, seed=30)
    test = jmake_batch(1, 3, jcfg.image_size, seed=31)
    jref, jtest = _jax(ref), _jax(test)
    params = random_params(model, 32, statics, jref.video, jref.smpl_parms, jref.cam_parms)
    params = _perturb(params, np.random.RandomState(33))
    out = jitted(lambda p, v, sp, c: model.apply({"params": p}, statics, v, sp, c),
                 params, jref.video, jref.smpl_parms, jref.cam_parms)
    _, metrics = jitted(lambda p, r, t: jstage1_loss(model, p, statics, r, t, jcfg),
                        params, jref, jtest)
    gb = {k: v.reshape((1, -1) + v.shape[1:])[:, 0] for k, v in out.gaussians.items()
          if k != "shs"}
    novel = jitted(lambda g, K, E: jrender_multi_view(g, K, E, 64, 64,
                                                      max_per_tile=jcfg.max_per_tile),
                   gb, jtest.cam_parms["intrinsic"], jtest.cam_parms["extrinsic"])
    # the ViT alone in fp32, to measure the bf16 noise of the image tokens
    from audio_motion_avatar_tpu.models.image_encoder import SapiensEncoder
    vit32 = SapiensEncoder(jcfg.image_feature_dim, jcfg.vit_depth, jcfg.vit_heads,
                           jcfg.vit_patch, jcfg.sapiens_resolution, compute_dtype=jnp.float32)
    tokens32 = jitted(lambda p, v: vit32.apply({"params": p}, v), params["sapiens_encoder"],
                      jref.video.reshape((2,) + jref.video.shape[2:]))

    rec = build_reconstructor(AvatarConfig.tiny(), device="cpu",
                              smplx_model=tsmplx.synthetic_model(seed=0, num_verts=300),
                              state_dict=params_from_flax(params))
    pref = to_device(make_batch(1, 2, (64, 64), seed=30), "cpu")
    ptest = to_device(make_batch(1, 3, (64, 64), seed=31), "cpu")
    vit_tokens = rec(pref, ptest).output.image_tokens.numpy()
    _same_image_tokens(rec.model, out.image_tokens)
    port = rec(pref, ptest)
    rendered, target = make_render_fn(rec.model, rec.statics)(pref)
    np.testing.assert_array_equal(rendered.numpy(), port.reference.numpy())
    np.testing.assert_array_equal(target.numpy(), pref.video.permute(0, 1, 3, 4, 2).numpy())
    np_ = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return np_(out), (vit_tokens, np.asarray(tokens32).reshape(out.image_tokens.shape)), \
        {k: float(v) for k, v in metrics.items()}, np.asarray(novel), port


def _same_image_tokens(avatar, tokens):
    """Make the port's ViT return the JAX run's image tokens (B, T, S, C)."""
    flat = torch.as_tensor(np.asarray(tokens)).reshape((-1,) + tuple(tokens.shape[2:]))
    avatar.sapiens_encoder.forward = lambda images: flat


def test_image_tokens_within_bf16_noise(tiny):
    out, (got, tokens32), _, _, port = tiny
    assert got.shape == out.image_tokens.shape == (1, 2, 64, 48)
    assert _noise_bounded(got, out.image_tokens, tokens32)
    np.testing.assert_array_equal(port.output.image_tokens.numpy(), out.image_tokens)


def test_triplane_and_smpl_tokens_match(tiny):
    out, _, _, _, port = tiny
    for name in ("triplane_tokens", "smpl_tokens"):
        got, want = getattr(port.output, name).numpy(), getattr(out, name)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("which", ["pred_smpl_1", "pred_smpl_2"])
def test_predicted_params_match(tiny, which):
    out, _, _, _, port = tiny
    want, got = getattr(out, which), getattr(port.output, which)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-4, rtol=0, err_msg=k)


def test_gaussians_match(tiny):
    out, _, _, _, port = tiny
    assert set(port.gaussians) == set(out.gaussians)
    for k, want in out.gaussians.items():
        np.testing.assert_allclose(port.gaussians[k].numpy(), want, atol=1e-4, rtol=0,
                                   err_msg=k)


def _frames_close(got, want):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).mean() <= 1e-3, np.abs(got - want).mean()
    per_view_std = got.reshape(-1, got.shape[-3] * got.shape[-2] * 3).std(1)
    assert (per_view_std > 0.01).all() and (got < 0.999).any(), per_view_std


def test_reference_views_match(tiny):
    out, _, _, _, port = tiny
    _frames_close(port.reference.numpy(), out.rendered_images)


def test_novel_views_match(tiny):
    _, _, _, novel, port = tiny
    assert port.novel.shape == (1, 3, 64, 64, 3)
    _frames_close(port.novel.numpy(), novel)


def test_stage1_loss_metrics_match(tiny):
    _, _, metrics, _, port = tiny
    for k, v in metrics.items():
        np.testing.assert_allclose(port.metrics[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    assert port.metrics["psnr_train"] > 0 and "psnr_test" in port.metrics


@pytest.fixture(scope="module")
def fixture_runs():
    """JAX: main2's build_stage2 + init_state2 on config_tiny with the
    demo's rendered-body data, CheckpointManager.restore of the trained
    fixture, AudioDrivenAvatar.apply with the reference render on, on the
    demo's first synthetic batch. Port: the same numpy weights through
    params_from_flax, the same inputs.

    The trained fixture renders near-white frames in the JAX package too
    (its gaussian heads barely moved from their init: opacity 0.1; the
    refiner and the decoded translations move most gaussians out of view),
    the known near-blank demo output. So the frames are also compared on
    the trained weights made visible: opacity and scale head biases raised
    by 4 and 2 (logits), the refiner's offsets, the decoded translations
    and root rotations damped as tests/test_torch_rollout.py does.
    Returns {"trained": (jax, port), "visible": (jax, port)}."""
    from audio_motion_avatar_tpu.configs import ConfigLoader
    from audio_motion_avatar_tpu.data.synthetic import SyntheticDataset
    from audio_motion_avatar_tpu.main2 import build_stage2, init_state2
    from audio_motion_avatar_tpu.training.checkpoints import CheckpointManager
    from audio_motion_avatar_tpu_torch.data.synthetic import VideoBatch
    from audio_motion_avatar_tpu_torch.models.audio_avatar import AudioDrivenAvatar
    from audio_motion_avatar_tpu_torch.models.renderer import build_renderer_statics

    cfg = ConfigLoader.load_config(str(CONFIG), ["dataset.render_gt=true"])
    model, statics, ac = build_stage2(cfg)
    state = init_state2(model, statics, cfg, ac, seed=0)
    state, ok = CheckpointManager(str(FIXTURE)).restore(state)
    assert ok
    trained = jax.tree_util.tree_map(np.asarray, state.params)
    ref, tgt, _ = SyntheticDataset(length=1, ref_frames=ac.triplane_input_frames,
                                   target_frames=ac.triplane_output_frames,
                                   image_size=ac.image_size, with_audio=True,
                                   audio_dim=ac.audio_feature_dim, render_gt=True)[0]
    jref, jtgt = _jax(ref), _jax(tgt)

    fields = {f.name for f in dataclasses.fields(AvatarConfig)}
    pcfg = AvatarConfig(**{k: v for k, v in dataclasses.asdict(ac).items() if k in fields})
    smplx_np = tsmplx.synthetic_model(seed=0, num_verts=int(statics.smplx_model.v_template.shape[0]))
    nverts = int(np.asarray(smplx_np.v_template).shape[0]) + int(np.asarray(smplx_np.faces).shape[0])
    pstatics = build_renderer_statics(smplx_np, "cpu", subdivide_steps=pcfg.subdivide_steps,
                                      densify=pcfg.densify_smplx_verts)
    r = to_device(VideoBatch(ref.video, ref.smpl_parms, ref.cam_parms), "cpu")
    g = to_device(VideoBatch(tgt.video, tgt.smpl_parms, tgt.cam_parms, tgt.audio_features), "cpu")

    visible = jax.tree_util.tree_map(np.copy, trained)
    rd = visible["triplane_gaussian"]["renderer"]
    rd["opacity_layer"]["bias"] += 4.0
    rd["scaling_layer"]["bias"] += 2.0
    rd["refine_mlp"]["layers_4"]["kernel"] *= 0.01
    rd["refine_mlp"]["layers_4"]["bias"] *= 0.0
    dec = visible["triplane_gaussian"]["smplx_triplane_encoder"]["smpl_decoder"]
    dec["transl"]["kernel"] *= 0.01
    dec["transl"]["bias"] *= 0.0
    dec["body_root_pose"]["kernel"] *= 0.01
    dec["body_root_pose"]["bias"] = np.array([1, 0, 0, 0, 1, 0], np.float32)
    runs = {}
    for name, params in (("trained", trained), ("visible", visible)):
        want = model.apply({"params": params}, statics, jref.video, jref.smpl_parms,
                           jref.cam_parms, jtgt.audio_features, jtgt.cam_parms,
                           render_ref=True)
        image_tokens = model.apply(
            {"params": params}, jref.video,
            method=lambda m, v: m.triplane_gaussian.sapiens_encoder(
                v.reshape((-1,) + v.shape[2:])))
        port = AudioDrivenAvatar(pcfg, nverts)
        port.load_state_dict(params_from_flax(params), strict=True)
        port.eval()
        _same_image_tokens(port.triplane_gaussian, np.asarray(image_tokens)[None])
        with torch.no_grad():
            got = port(pstatics, r.video, r.smpl_parms, r.cam_parms, g.audio_features,
                       g.cam_parms, render_ref=True)
        runs[name] = (jax.tree_util.tree_map(np.asarray, want), got)
    return runs


def test_fixture_tokens_match(fixture_runs):
    """Reference and rolled-out tokens of the trained weights."""
    want, got = fixture_runs["trained"]
    for name in ("ref_triplane_tokens", "ref_smpl_tokens", "output_triplane_tokens",
                 "output_smpl_tokens"):
        g, w = getattr(got, name).numpy(), getattr(want, name)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("which", ["rendered_images", "ref_rendered"])
def test_fixture_frames_match(fixture_runs, which):
    """Trained weights: mean |diff| <= 1e-3 (near-white on both sides);
    made visible: mean |diff| <= 1e-3 and not blank."""
    want, got = fixture_runs["trained"]
    g, w = getattr(got, which).numpy(), getattr(want, which)
    assert g.shape == w.shape and np.isfinite(g).all()
    assert np.abs(g - w).mean() <= 1e-3
    want, got = fixture_runs["visible"]
    _frames_close(getattr(got, which).numpy(), getattr(want, which))


def test_fixture_params_match(fixture_runs):
    want, got = fixture_runs["trained"]
    for k, w in want.pred_smplx_future.items():
        np.testing.assert_allclose(got.pred_smplx_future[k].numpy(), w, atol=1e-4, rtol=0,
                                   err_msg=k)

