"""The port's upsampler and serving rollout with the Winograd convolutions
(kernels K9a, K9b) against the JAX package, whose Pallas kernels run in
interpret mode on the CPU. The kernels take C % 128 == 0, so these run at
128 channels.

- The upsampler with conv_impl 'winograd' / 'winograd_gn', dense and with
  the sparse final level, against the JAX upsampler on the same
  parameters: fp32 at 3e-4 (tests/test_winograd.py's own tolerance); the
  same parameter names as with direct convs; which convs take which kernel.
- The slice as a whole: the tiny serving rollout of test_torch_rollout.py
  at 128 channels with upsampler_conv='winograd', against the JAX serving
  program (K9a in interpret mode): frames mean |diff| <= 1e-3, PSNR >= 50
  dB, not blank.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_motion_avatar_tpu.data.synthetic import make_batch
from audio_motion_avatar_tpu.models import upsampler as jax_up
from audio_motion_avatar_tpu.ops import smplx as jax_smplx

from audio_motion_avatar_tpu_torch.models import upsampler as up
from audio_motion_avatar_tpu_torch.models.config import AvatarConfig, serving_config
from audio_motion_avatar_tpu_torch.ops import smplx as torch_smplx
from audio_motion_avatar_tpu_torch.ops import winograd as W
from audio_motion_avatar_tpu_torch.serve import build_rollout
from audio_motion_avatar_tpu_torch.weights import params_from_flax
from torch_parity import (jax_serving_avatar, load_flax, one_torch_thread,  # noqa: F401
                          random_params, t)


@pytest.mark.parametrize("conv_impl", ["winograd", "winograd_gn"])
@pytest.mark.parametrize("sparse", [False, True])
def test_upsampler_matches_jax(conv_impl, sparse):
    """Two blocks, 8 -> 32 px planes, 128 channels, GroupNorm (winograd_gn
    fuses the dense levels' norms; the sparse level is plain Winograd)."""
    B, C, R, N, cap = 1, 128, 8, 40, 3
    rng = np.random.RandomState(8)
    planes = rng.randn(B, 3, C, R, R).astype(np.float32)
    uv = np.clip(rng.randn(B, 3, N, 2) * 0.3 - 0.3, -1, 1).astype(np.float32)
    jmod = jax_up.TriplaneUpsampler(feature_dim=C, num_blocks=2, channels_last=True,
                                    sparse_final=sparse, sparse_max_tiles=cap,
                                    upconv="dilated", conv_impl=conv_impl)
    jargs = (jnp.asarray(planes), jnp.asarray(uv)) if sparse else (jnp.asarray(planes),)
    params = random_params(jmod, 9, *jargs)
    want = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a))(params, *jargs)
    tmod = load_flax(up.TriplaneUpsampler(C, 2, sparse_final=sparse, sparse_max_tiles=cap,
                                          conv_impl=conv_impl), params)
    direct = up.TriplaneUpsampler(C, 2, sparse_final=sparse, sparse_max_tiles=cap)
    assert list(tmod.state_dict()) == list(direct.state_dict())
    with torch.no_grad():
        got = tmod(t(planes), t(uv) if sparse else None)
    if not sparse:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-4, rtol=0)
        return
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() > 0
    np.testing.assert_allclose(got.tiles.numpy()[valid], np.asarray(want.tiles)[valid],
                               atol=3e-4, rtol=0)


def test_upsampler_routes_through_the_kernels(monkeypatch):
    """Which kernel each conv takes, counted on the plain versions: 128
    channels, two blocks, GroupNorm. 'winograd': every ResBlock conv is
    K9a (dense SAME, sparse VALID); 'winograd_gn': the dense level's two
    convs are K9b, the sparse level's K9a; 'xla' and a 64-wide upsampler
    (the kernels need C % 128 == 0): none."""
    calls = {"K9a": 0, "K9b": 0}
    for name, key in (("winograd_conv3x3_plain", "K9a"),
                      ("winograd_conv3x3_gn_relu_plain", "K9b")):
        def counted(*a, _f=getattr(W, name), _k=key, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(W, name, counted)
    rng = np.random.RandomState(3)
    uv = t(np.clip(rng.randn(1, 3, 40, 2) * 0.3, -1, 1).astype(np.float32))
    cases = [("winograd", 128, {"K9a": 4}, {"K9a": 4}),
             ("winograd_gn", 128, {"K9b": 4}, {"K9b": 2, "K9a": 2}),
             ("xla", 128, {}, {}), ("winograd", 64, {}, {})]
    for impl, C, dense, sparse in cases:
        mod = up.TriplaneUpsampler(C, 2, sparse_final=True, sparse_max_tiles=3,
                                   conv_impl=impl)
        for p in mod.parameters():
            torch.nn.init.normal_(p, std=0.05)
        planes = t(rng.randn(1, 3, C, 8, 8).astype(np.float32))
        for points, want in ((None, dense), (uv, sparse)):
            calls.update(K9a=0, K9b=0)
            with torch.no_grad():
                mod(planes, points)
            assert calls == {"K9a": 0, "K9b": 0, **want}, (impl, C, points is None, calls)
    with pytest.raises(ValueError, match="conv_impl"):
        up.TriplaneUpsampler(128, 1, conv_impl="fft")


OVERRIDES = dict(num_upsample_blocks=2, max_per_tile=512, upsampler_sparse_max_tiles=3,
                 upsampler_norm="affine", compute_dtype="float32", frames_per_chunk=6,
                 triplane_feature_dim=128, smpl_token_dim=128, upsampler_conv="winograd")
B = 2


@pytest.fixture(scope="module")
def rollouts():
    from test_torch_rollout import _perturb
    cfg, model, chunk = jax_serving_avatar(
        jax_smplx.synthetic_model(seed=0, num_verts=300), **OVERRIDES)
    T_in, T_out = cfg.triplane_input_frames, cfg.triplane_output_frames
    C, L = cfg.triplane_feature_dim, cfg.smpl_token_len
    rng = np.random.RandomState(0)
    tri = rng.randn(B, T_in, C, 3 * cfg.triplane_resolution ** 2).astype(np.float32) * 0.1
    smpl = rng.randn(B, T_in, C, L).astype(np.float32) * 0.1
    audio = rng.randn(B, T_out, cfg.audio_feature_dim).astype(np.float32) * 0.1
    cams = make_batch(B, T_out, cfg.image_size, seed=3).cam_parms
    jcam = {k: jnp.asarray(v) for k, v in cams.items()}
    params = random_params(model, 7, tri, smpl, audio, jcam,
                           method=lambda m, *a: chunk(m, *a, render=False))
    params = _perturb(params, np.random.RandomState(8))
    # 128-wide features move the points further: small position offsets (as
    # test_torch_rollout's _perturb_serving), or they leave the view
    params["triplane_gaussian"]["renderer"]["xyz_layer"]["kernel"] *= 0.01
    want = jax.jit(lambda p, *a: model.apply({"params": p}, *a, method=chunk))(
        params, tri, smpl, audio, jcam)
    pcfg = serving_config(AvatarConfig.tiny(image_size=(32, 32)), **OVERRIDES)
    port = build_rollout(pcfg, device="cpu",
                         smplx_model=torch_smplx.synthetic_model(seed=0, num_verts=300),
                         state_dict=params_from_flax(params))
    with torch.no_grad():
        got = port(t(tri), t(smpl), t(audio), {k: t(v) for k, v in cams.items()})
    return np.asarray(want[0]), got[0].numpy()


def test_winograd_rollout_frames_match_jax(rollouts):
    want, got = rollouts
    assert got.shape == want.shape == (B, 6, 32, 32, 3)
    diff = np.abs(got - want)
    psnr = 10 * np.log10(1.0 / max(float((diff ** 2).mean()), 1e-20))
    assert diff.mean() <= 1e-3 and psnr >= 50.0, (diff.mean(), psnr)


def test_winograd_rollout_frames_not_blank(rollouts):
    for frames in rollouts:
        assert np.isfinite(frames).all()
        per_frame_std = frames.reshape(-1, 32 * 32 * 3).std(axis=1)
        assert (per_frame_std > 0.01).all(), per_frame_std
        assert (frames < 0.999).any()
