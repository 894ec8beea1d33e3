"""The whole serving slice: the JAX rollout vs the PyTorch port, same weights.

One tiny rollout (AvatarConfig.tiny, 32x32, a 300-vertex synthetic SMPL-X,
fp32, B=2, T_in=2, T_out=6, two frame chunks) runs through the JAX
package's serving program (audio AR rollout -> shared SMPL-X decoder ->
sparse-final upsampler, quad sampling, PTv3 refiner, heads, splat) and
through `audio_motion_avatar_tpu_torch.serve`, with the JAX parameters
converted by `weights.params_from_flax` and the same tokens, audio and
cameras.

Splat binning matched: on the CPU the JAX renderer composites through its
'tiles' route instead of the segmented kernel. With K = max_per_tile = 512
>= N = 300 gaussians no tile overflows, and large_cap = 2048 >= N keeps the
port's binning single-tier, so the two composite the same depth-ordered
gaussians per tile (rounding differs: prefix sum vs sequential).

Tolerances: tokens and SMPL-X params 1e-4 (fp32, reassociated matmuls);
frames mean |diff| <= 1e-3 and PSNR >= 50 dB.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_motion_avatar_tpu.data.synthetic import make_batch
from audio_motion_avatar_tpu.models.config import AvatarConfig as JaxConfig
from audio_motion_avatar_tpu.ops import smplx as jax_smplx

from audio_motion_avatar_tpu_torch.models.config import AvatarConfig, serving_config
from audio_motion_avatar_tpu_torch.ops import smplx as torch_smplx
from audio_motion_avatar_tpu_torch.serve import build_rollout, serve
from audio_motion_avatar_tpu_torch.weights import params_from_flax
from test_torch_train_stage1 import FAST_COMPILE
from torch_parity import jax_serving_avatar, one_torch_thread, random_params  # noqa: F401

OVERRIDES = dict(num_upsample_blocks=2, max_per_tile=512,
                 upsampler_sparse_max_tiles=3, upsampler_norm="affine",
                 compute_dtype="float32", frames_per_chunk=6)
B = 2


def _perturb(params, rng):
    """Non-zero heads so the frames are not uniform gaussians: noise on the
    five head kernels, larger scale and opacity biases."""
    r = params["triplane_gaussian"]["renderer"]
    for name in ("xyz_layer", "rotation_layer", "scaling_layer",
                 "opacity_layer", "shs_layer"):
        k = r[name]["kernel"]
        r[name]["kernel"] = (k + 1e-2 * rng.randn(*k.shape)).astype(np.float32)
    r["scaling_layer"]["bias"] = np.full(3, 1.5, np.float32)
    r["opacity_layer"]["bias"] = np.full(1, 2.0, np.float32)
    # keep the body in view and the tokens O(1), as trained weights do:
    # small refiner offsets and translations, a damped token update
    r["refine_mlp"]["layers_4"]["kernel"] *= 0.01
    dec = params["triplane_gaussian"]["smplx_triplane_encoder"]["smpl_decoder"]
    dec["transl"]["kernel"] *= 0.01
    dec["transl"]["bias"] *= 0.0
    dec["body_root_pose"]["kernel"] *= 0.01
    dec["body_root_pose"]["bias"] = np.array([1, 0, 0, 0, 1, 0], np.float32)
    params["audio_triplane"]["transformer"]["proj_out"]["kernel"] *= 0.1
    return params


@pytest.fixture(scope="module")
def runs():
    smplx_np = torch_smplx.synthetic_model(seed=0, num_verts=300)
    cfg, model, chunk = jax_serving_avatar(
        jax_smplx.synthetic_model(seed=0, num_verts=300), **OVERRIDES)

    T_in, T_out = cfg.triplane_input_frames, cfg.triplane_output_frames
    C, L = cfg.triplane_feature_dim, cfg.smpl_token_len
    rng = np.random.RandomState(0)
    tri = rng.randn(B, T_in, C, 3 * cfg.triplane_resolution ** 2).astype(np.float32) * 0.1
    smpl = rng.randn(B, T_in, C, L).astype(np.float32) * 0.1
    audio = [rng.randn(B, T_out, cfg.audio_feature_dim).astype(np.float32) * 0.1
             for _ in range(2)]
    cams = make_batch(B, T_out, cfg.image_size, seed=3).cam_parms

    jcam = {k: jnp.asarray(v) for k, v in cams.items()}
    params = random_params(model, 7, tri, smpl, audio[0], jcam,
                           method=lambda m, *a: chunk(m, *a, render=False))
    params = _perturb(params, np.random.RandomState(8))
    rollout = jax.jit(lambda p, *a: model.apply({"params": p}, *a, method=chunk)).lower(
        params, tri, smpl, audio[0], jcam).compile(compiler_options=FAST_COMPILE)

    # JAX: two requests with the host-side window slide
    jax_out, t, s = [], tri, smpl
    for aud in audio:
        r, ot, os_, pred = rollout(params, t, s, aud, jcam)
        jax_out.append((np.asarray(r), np.asarray(ot), np.asarray(os_),
                        {k: np.asarray(v) for k, v in pred.items()}))
        t, s = np.asarray(ot)[:, -T_in:], np.asarray(os_)[:, -T_in:]

    pcfg = serving_config(AvatarConfig.tiny(image_size=(32, 32)), **OVERRIDES)
    port = build_rollout(pcfg, device="cpu", smplx_model=smplx_np,
                         state_dict=params_from_flax(params))
    tcams = {k: torch.as_tensor(v) for k, v in cams.items()}
    torch_out, state = [], (torch.as_tensor(tri), torch.as_tensor(smpl))
    for aud in audio:
        with torch.no_grad():
            r, ot, os_, pred = port.model.rollout(port.statics, *state,
                                                  torch.as_tensor(aud), tcams)
        torch_out.append((r.numpy(), ot.numpy(), os_.numpy(),
                          {k: v.numpy() for k, v in pred.items()}))
        state = (ot[:, -T_in:], os_[:, -T_in:])
    served = list(serve(port, torch.as_tensor(tri), torch.as_tensor(smpl),
                        [(torch.as_tensor(a), tcams) for a in audio]))
    return jax_out, torch_out, served


@pytest.mark.parametrize("req", [0, 1])
def test_tokens_match(runs, req):
    jax_out, torch_out, _ = runs
    np.testing.assert_allclose(torch_out[req][1], jax_out[req][1], atol=1e-4, rtol=0)
    np.testing.assert_allclose(torch_out[req][2], jax_out[req][2], atol=1e-4, rtol=0)


@pytest.mark.parametrize("req", [0, 1])
def test_smplx_params_match(runs, req):
    jax_out, torch_out, _ = runs
    jp, tp = jax_out[req][3], torch_out[req][3]
    assert set(jp) == set(tp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], atol=1e-4, rtol=0, err_msg=k)


@pytest.mark.parametrize("req", [0, 1])
def test_frames_match(runs, req):
    jax_out, torch_out, _ = runs
    a, b = torch_out[req][0], jax_out[req][0]
    assert a.shape == b.shape == (B, 6, 32, 32, 3)
    diff = np.abs(a - b)
    mse = float((diff ** 2).mean())
    psnr = 10 * np.log10(1.0 / max(mse, 1e-20))
    assert diff.mean() <= 1e-3, diff.mean()
    assert psnr >= 50.0, psnr


def test_frames_not_blank(runs):
    jax_out, torch_out, _ = runs
    for frames in (torch_out[0][0], jax_out[0][0]):
        assert np.isfinite(frames).all()
        per_frame_std = frames.reshape(-1, 32 * 32 * 3).std(axis=1)
        assert (per_frame_std > 0.01).all(), per_frame_std
        assert (frames < 0.999).any()


JAX_EXECUTION_KNOBS = {"frames_scan_remat", "frames_scan_unroll", "quad_builder"}


def test_serving_profile_matches_jax():
    """The port's serving profile is the JAX one without its execution
    knobs, and every field of the port's config has the JAX default."""
    import dataclasses
    from audio_motion_avatar_tpu.configs import build as jax_build
    from audio_motion_avatar_tpu.models.config import AvatarConfig as JaxConfig
    from audio_motion_avatar_tpu_torch.models import config as port

    want = {k: v for k, v in jax_build.SERVING_PROFILE.items()
            if k not in JAX_EXECUTION_KNOBS}
    assert port.SERVING_PROFILE == want
    assert port.SERVING_PROFILE_MODEL == jax_build.SERVING_PROFILE_MODEL
    jax_defaults = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    for f in dataclasses.fields(AvatarConfig):
        if f.name in port.PORT_ONLY_FIELDS:     # the JAX package's form by default
            assert f.name not in jax_defaults and f.default == port.PORT_ONLY_FIELDS[f.name]
            assert getattr(AvatarConfig.tiny(), f.name) == f.default, f.name
            continue
        assert jax_defaults[f.name] == f.default, f.name
        assert getattr(AvatarConfig.tiny(), f.name) == getattr(JaxConfig.tiny(), f.name), f.name


def _jax_tree(stage1, **knobs):
    """The JAX tiny model's parameter tree with `knobs` set (traced with
    eval_shape, drawn from a seed): the serving rollout's, or with stage1
    the TriplaneGaussianAvatar's."""
    jbody = jax_smplx.synthetic_model(seed=0, num_verts=300)
    if not stage1:
        cfg, model, chunk = jax_serving_avatar(jbody, **knobs)
        rng = np.random.RandomState(0)
        C, L = cfg.triplane_feature_dim, cfg.smpl_token_len
        tri = rng.randn(1, 2, C, 3 * cfg.triplane_resolution ** 2).astype(np.float32)
        smpl = rng.randn(1, 2, C, L).astype(np.float32)
        audio = rng.randn(1, 6, cfg.audio_feature_dim).astype(np.float32)
        cams = {k: jnp.asarray(v) for k, v in make_batch(1, 6, cfg.image_size, seed=3)
                .cam_parms.items()}
        return random_params(model, 1, tri, smpl, audio, cams,
                             method=lambda m, *a: chunk(m, *a, render=False))
    from audio_motion_avatar_tpu.models.avatar import TriplaneGaussianAvatar as JaxAvatar
    from audio_motion_avatar_tpu.models.ptv3 import build_point_refiner
    from audio_motion_avatar_tpu.models.renderer import build_renderer_statics
    cfg = dataclasses.replace(JaxConfig.tiny(image_size=(32, 32)), **knobs)
    statics = build_renderer_statics(jbody, subdivide_steps=cfg.subdivide_steps)
    model = JaxAvatar(cfg=cfg, num_verts_encoder=300 + np.asarray(jbody.faces).shape[0],
                      point_refiner=build_point_refiner(cfg))
    b = make_batch(1, 1, cfg.image_size, seed=0)
    return random_params(model, 2, statics, jnp.asarray(b.video), b.smpl_parms,
                         {k: jnp.asarray(v) for k, v in b.cam_parms.items()})


@pytest.mark.parametrize("knob,value", [("sample_quad", False),
                                        ("splat_segmented", False),
                                        ("upsampler_upconv", "poly")])
def test_renderer_rejects_non_serving_knobs(knob, value):
    """The serving form without the quad sampler is the JAX package's 4-tap
    sparse sampler (refused before it was ported): the model builds, reads
    the knob and holds the JAX model's parameters leaf for leaf (its forward
    against JAX: tests/test_torch_render_forms.py). The tile splat (K1) and
    the poly up-convolution belong to the default form: the model builds
    and selects them."""
    from audio_motion_avatar_tpu_torch.models.audio_avatar import AudioDrivenAvatar
    cfg = serving_config(AvatarConfig.tiny(image_size=(32, 32)), **{knob: value})
    model = AudioDrivenAvatar(cfg)
    assert getattr(model.renderer.cfg, knob) == value
    if knob == "sample_quad":
        tree = _jax_tree(False, **{knob: value})
        model.load_state_dict(params_from_flax(tree), strict=True)


@pytest.mark.parametrize("knob,value", [("rgb", False), ("upsample_triplane_encoder", True),
                                        ("upsample_triplane", False)])
def test_renderer_rejects_unported_knobs(knob, value):
    """SH colours (ops/sh.py), the encoder-side upsample path (the stage-1
    triplane encoder's TriplaneDownsampler, so the stage-1 stack is built)
    and the planes without the upsampler, refused before they were ported,
    now build: the stage-1 model holds the JAX model's parameters of that
    configuration leaf for leaf (their forwards against JAX:
    tests/test_torch_render_forms.py, tests/test_torch_stage1.py)."""
    from audio_motion_avatar_tpu_torch.models.audio_avatar import AudioDrivenAvatar
    cfg = dataclasses.replace(AvatarConfig.tiny(image_size=(32, 32)), **{knob: value},
                              **({"sh_degree": 1} if knob == "rgb" else {}))
    model = AudioDrivenAvatar(cfg, num_verts_encoder=300 + 512)
    tree = _jax_tree(True, **{knob: value}, **({"sh_degree": 1} if knob == "rgb" else {}))
    model.triplane_gaussian.load_state_dict(params_from_flax(tree), strict=True)
    tg = model.triplane_gaussian
    assert hasattr(tg.renderer, "upsampler") == cfg.upsample_triplane
    assert hasattr(tg.smplx_triplane_encoder, "triplane_downsampler") == \
        cfg.upsample_triplane_encoder
    assert tg.renderer.shs_layer.out_features == (3 if cfg.rgb else 12)


@pytest.mark.parametrize("conv", ["winograd", "winograd_gn", "fft"])
def test_renderer_builds_the_winograd_upsampler(conv):
    """upsampler_conv 'winograd' and 'winograd_gn' (kernels K9a, K9b) build
    the upsampler with that conv_impl; any other value raises."""
    from audio_motion_avatar_tpu_torch.models.audio_avatar import AudioDrivenAvatar
    cfg = dataclasses.replace(AvatarConfig.tiny(image_size=(32, 32)), upsampler_conv=conv)
    if conv == "fft":
        with pytest.raises(ValueError, match="conv_impl"):
            AudioDrivenAvatar(cfg)
        return
    res = AudioDrivenAvatar(cfg).renderer.upsampler.up_0.res
    assert res.conv_impl == conv


def test_serve_loop_slides_window(runs):
    """serve() answers each request with the same frames as the explicit
    rollout + host-side slide."""
    _, torch_out, served = runs
    assert len(served) == 2
    for (rendered, pred), ref in zip(served, torch_out):
        np.testing.assert_array_equal(rendered.numpy(), ref[0])
        np.testing.assert_array_equal(pred["transl"].numpy(), ref[3]["transl"])


def test_serving_rollout_from_reference_frames_matches_jax():
    """main2's demo start: the stage-1 token pass (serving profile, render
    off) on two streams' reference frames, then one rollout chunk from those
    tokens, in the JAX package and through the port's
    `build_rollout(stage1=True)`, `Rollout.tokens` and `serve`. The port's
    ViT returns the JAX image tokens (see the module docstring)."""
    from audio_motion_avatar_tpu.models.renderer import build_renderer_statics as jstatics
    from audio_motion_avatar_tpu_torch.data.synthetic import make_batch as tmake_batch, to_device
    from test_torch_reconstruct import _frames_close, _same_image_tokens

    over = dict(num_upsample_blocks=2, max_per_tile=512, upsampler_sparse_max_tiles=3,
                upsampler_norm="affine", compute_dtype="float32", frames_per_chunk=6)
    jbody = jax_smplx.synthetic_model(seed=0, num_verts=300)
    cfg, model, chunk = jax_serving_avatar(jbody, **over)
    statics = jstatics(jbody, subdivide_steps=cfg.subdivide_steps,
                       densify=cfg.densify_smplx_verts)
    ref = make_batch(2, cfg.triplane_input_frames, cfg.image_size, seed=50)
    tgt = make_batch(2, cfg.triplane_output_frames, cfg.image_size, seed=51,
                      with_audio=True, audio_dim=cfg.audio_feature_dim)
    jref = jax.tree_util.tree_map(jnp.asarray, ref)
    jtgt = jax.tree_util.tree_map(jnp.asarray, tgt)

    def demo(m, v, sp, c, aud, cams):
        out = m.triplane_gaussian(statics, v, sp, c, render=False)
        tokens = m.triplane_gaussian.sapiens_encoder(v.reshape((-1,) + v.shape[2:]))
        return (out.triplane_tokens, out.smpl_tokens, tokens,
                chunk(m, out.triplane_tokens, out.smpl_tokens, aud, cams))

    args = (jref.video, jref.smpl_parms, jref.cam_parms, jtgt.audio_features, jtgt.cam_parms)
    params = random_params(model, 52, *args, method=demo)
    params = _perturb_serving(params)
    fwd = jax.jit(lambda p, *a: model.apply({"params": p}, *a, method=demo))
    tri, smpl, image_tokens, (frames, _, _, _) = jax.tree_util.tree_map(
        np.asarray, fwd.lower(params, *args).compile(compiler_options=FAST_COMPILE)(params, *args))

    pcfg = serving_config(AvatarConfig.tiny(image_size=(32, 32)), **over)
    roll = build_rollout(pcfg, device="cpu", stage1=True,
                         smplx_model=torch_smplx.synthetic_model(seed=0, num_verts=300),
                         state_dict=params_from_flax(params))
    _same_image_tokens(roll.model.triplane_gaussian,
                       image_tokens.reshape(ref.video.shape[:2] + image_tokens.shape[1:]))
    r, g = to_device(tmake_batch(2, 2, (32, 32), seed=50), "cpu"), tgt
    ptri, psmpl = roll.tokens(r.video, r.smpl_parms, r.cam_parms)
    np.testing.assert_allclose(ptri.numpy(), tri, atol=1e-4, rtol=0)
    np.testing.assert_allclose(psmpl.numpy(), smpl, atol=1e-4, rtol=0)
    rendered, _ = next(serve(roll, ptri, psmpl, [(torch.as_tensor(g.audio_features),
                                                 {k: torch.as_tensor(v) for k, v in
                                                  g.cam_parms.items()})]))
    _frames_close(rendered.numpy(), frames)


def _perturb_serving(params):
    """Visible, upright gaussians from seeded weights (as test_torch_rollout)."""
    r = params["triplane_gaussian"]["renderer"]
    r["scaling_layer"]["bias"] = np.full(3, 1.5, np.float32)
    r["opacity_layer"]["bias"] = np.full(1, 2.0, np.float32)
    r["xyz_layer"]["kernel"] = r["xyz_layer"]["kernel"] * 0.01
    r["refine_mlp"]["layers_4"]["kernel"] *= 0.01
    dec = params["triplane_gaussian"]["smplx_triplane_encoder"]["smpl_decoder"]
    dec["transl"]["kernel"] *= 0.01
    dec["transl"]["bias"] *= 0.0
    dec["body_root_pose"]["kernel"] *= 0.01
    dec["body_root_pose"]["bias"] = np.array([1, 0, 0, 0, 1, 0], np.float32)
    params["audio_triplane"]["transformer"]["proj_out"]["kernel"] *= 0.1
    return params
