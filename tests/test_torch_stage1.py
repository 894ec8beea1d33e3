"""The port's stage-1 modules vs the JAX package's, one comparison each.

Same numpy-seeded inputs and parameters on both sides (tests/torch_parity.py),
small widths, fp32 unless a test says otherwise. Tolerances: integer
results (cell ids) exact; gathers, scatters and z-buffer lifting exact or
1e-6 (the same fp32 operations); resizes and bilinear samples 1e-5; the
deep stacks (ViT, encoder, fusion, upsampler) 1e-4 absolute
(reassociated fp32 matmuls); losses 1e-5 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_motion_avatar_tpu.models import fusion as jfusion
from audio_motion_avatar_tpu.models import image_encoder as jie
from audio_motion_avatar_tpu.models import tokenizers as jtok
from audio_motion_avatar_tpu.models import triplane_encoder as jte
from audio_motion_avatar_tpu.models import upsampler as jup
from audio_motion_avatar_tpu.ops import point_raster as jpr
from audio_motion_avatar_tpu.ops import smplx as jsmplx
from audio_motion_avatar_tpu.ops import subdivision as jsub
from audio_motion_avatar_tpu.ops import triplane as jtp
from audio_motion_avatar_tpu.utils import losses as jloss

from audio_motion_avatar_tpu_torch.data.synthetic import make_batch
from audio_motion_avatar_tpu_torch.models import fusion as tfusion
from audio_motion_avatar_tpu_torch.models import image_encoder as tie
from audio_motion_avatar_tpu_torch.models import tokenizers as ttok
from audio_motion_avatar_tpu_torch.models import triplane_encoder as tte
from audio_motion_avatar_tpu_torch.models import upsampler as tup
from audio_motion_avatar_tpu_torch.ops import point_raster as tpr
from audio_motion_avatar_tpu_torch.ops import smplx as tsmplx
from audio_motion_avatar_tpu_torch.ops import subdivision as tsub
from audio_motion_avatar_tpu_torch.ops import triplane as ttp
from audio_motion_avatar_tpu_torch.utils import losses as tloss
from torch_parity import load_flax, one_torch_thread, random_params, t  # noqa: F401


def body_points(B=2, n=500, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, n, 3) * np.array([0.3, 0.7, 0.2])).astype(np.float32)


def test_face_center_densify_matches_jax():
    model = tsmplx.synthetic_model(seed=0, num_verts=300)
    verts = body_points(2, 300, 1)
    want = np.asarray(jsub.face_center_densify(jnp.asarray(verts), np.asarray(model.faces)))
    got = tsub.face_center_densify(t(verts), model.faces).numpy()
    assert got.shape == want.shape == (2, 300 + np.asarray(model.faces).shape[0], 3)
    np.testing.assert_array_equal(got, want)


def test_plane_cell_index_exact():
    pts = body_points() * 2.0                      # some points beyond the radius
    want = np.asarray(jtp.plane_cell_index(jnp.asarray(pts), 1.4, 8))
    got = ttp.plane_cell_index(t(pts), 1.4, 8).numpy()
    np.testing.assert_array_equal(got, want)


def test_segment_max_gather_matches_jax():
    """Empty cells read 0 (segment_max's -inf in JAX)."""
    rng = np.random.RandomState(2)
    v = rng.randn(300, 6).astype(np.float32) - 3.0   # all negative: 0 would win a 0-init max
    idx = rng.randint(0, 40, 300).astype(np.int32)
    want = np.asarray(jtp._segment_max_gather(jnp.asarray(v), jnp.asarray(idx), 64))
    got = ttp._segment_max_gather(t(v)[None], torch.as_tensor(idx, dtype=torch.long)[None], 64)
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_pool_local_max_and_scatter_mean_match_jax():
    pts = body_points()
    rng = np.random.RandomState(3)
    vals = rng.randn(2, 500, 8).astype(np.float32)
    cell = jtp.plane_cell_index(jnp.asarray(pts), 1.4, 8)
    want_pool = np.asarray(jtp.pool_local_max(jnp.asarray(vals), cell, 8))
    want_mean = np.asarray(jtp.scatter_mean_plane(jnp.asarray(vals), cell[:, 1], 8))
    tcell = torch.as_tensor(np.asarray(cell), dtype=torch.long)
    np.testing.assert_allclose(ttp.pool_local_max(t(vals), tcell, 8).numpy(), want_pool,
                               atol=1e-6, rtol=0)
    got_mean = ttp.scatter_mean_plane(t(vals), tcell[:, 1], 8).numpy()
    assert got_mean.shape == (2, 8, 8, 8) and (want_mean == 0).any()
    np.testing.assert_allclose(got_mean, want_mean, atol=1e-6, rtol=0)


def test_sample_triplane_nhwc_matches_jax():
    """Points past the planes' edges read zero-padded taps."""
    rng = np.random.RandomState(4)
    planes = rng.randn(2, 3, 12, 10, 5).astype(np.float32)
    pts = body_points(2, 300, 5) * 2.2
    want = np.asarray(jtp.sample_triplane_nhwc(jnp.asarray(planes), jnp.asarray(pts), 1.4))
    got = ttp.sample_triplane_nhwc(t(planes), t(pts), 1.4).numpy()
    assert got.shape == (2, 300, 15)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    g = rng.uniform(-1.2, 1.2, (3, 50, 2)).astype(np.float32)
    want = np.stack([np.asarray(jtp.grid_sample_2d_nhwc(jnp.asarray(planes[0, i]), jnp.asarray(g[i])))
                     for i in range(3)])
    got = ttp.grid_sample_2d_nhwc(t(planes[0]), t(g)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_planes_to_tokens_exact():
    planes = np.random.RandomState(5).randn(2, 3, 4, 5, 5).astype(np.float32)
    want = np.asarray(jtp.planes_to_tokens(jnp.asarray(planes)))
    np.testing.assert_array_equal(ttp.planes_to_tokens(t(planes)).numpy(), want)
    np.testing.assert_array_equal(ttp.tokens_to_planes(t(want), 5).numpy(), planes)


def _cams(B, H, W, seed):
    cams = make_batch(B, 1, (H, W), seed=seed).cam_parms
    return cams["extrinsic"][:, 0], cams["intrinsic"][:, 0]


def test_point_raster_matches_jax():
    """Two-pass z-buffer: occluded and off-screen points read 0; out-of-bounds
    points share the extra bucket."""
    H = W = 32
    E, K = _cams(2, H, W, 6)
    pts = body_points(2, 800, 6)
    pts[:, :50] *= 4.0                               # some off-screen
    feats = np.random.RandomState(7).randn(2, 5, H, W).astype(np.float32)
    u, v, z = jpr.project_to_pixels(jnp.asarray(pts[0]), jnp.asarray(E[0]), jnp.asarray(K[0]))
    tu, tv, tz = tpr.project_to_pixels(t(pts), t(E), t(K))
    for a, b in ((tu, u), (tv, v), (tz, z)):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), atol=1e-4, rtol=1e-6)
    want = np.asarray(jpr.lift_image_features(jnp.asarray(pts), jnp.asarray(E),
                                              jnp.asarray(K), jnp.asarray(feats)))
    got = tpr.lift_image_features(t(pts), t(E), t(K), t(feats)).numpy()
    hidden = (want == 0).all(-1)
    assert hidden.any() and not hidden.all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(64, 96), (32, 32), (64, 64)])
def test_preprocess_matches_jax(shape):
    """96 wide -> padded to 96^2 and downsampled to 64^2 (jax.image.resize
    antialiases: a triangle kernel widened by the scale); 32^2 upsampled;
    64^2 left as it is."""
    img = np.random.RandomState(8).rand(2, 3, *shape).astype(np.float32)
    want = np.asarray(jie.preprocess(jnp.asarray(img), 64))
    got = tie.preprocess(t(img), 64).numpy()
    assert got.shape == (2, 3, 64, 64)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


VIT = dict(width=48, depth=2, heads=2, patch=8, resolution=64)


def test_vit_block_matches_jax():
    x = np.random.RandomState(9).randn(2, 64, 48).astype(np.float32)
    jmod = jie.ViTBlock(48, 2)
    params = random_params(jmod, 10, jnp.asarray(x))
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = load_flax(tie.ViTBlock(48, 2), params)(t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sapiens_encoder_matches_jax(dtype):
    """fp32: 1e-4. bf16 (the model's own setting, as the reference's
    autocast): both sides round to bf16 after each matmul and in the
    residual stream, but in different places of their fused ops (XLA
    rounds a projection before its bias add, torch after), so they differ
    by bf16 rounding noise: the port's distance from the JAX bf16 output,
    mean and max, must stay within 2x the JAX bf16 output's own distance
    from the JAX fp32 one."""
    img = np.random.RandomState(11).rand(2, 3, 64, 64).astype(np.float32)
    jmod = jie.SapiensEncoder(**VIT, compute_dtype=jnp.float32)
    params = random_params(jmod, 12, jnp.asarray(img))
    want32 = np.asarray(jmod.apply({"params": params}, jnp.asarray(img)))
    tdt = None if dtype == "float32" else torch.bfloat16
    with torch.no_grad():
        got = load_flax(tie.SapiensEncoder(**VIT, compute_dtype=tdt), params)(t(img)).numpy()
    assert got.shape == (2, 64, 48) and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, want32, atol=1e-4, rtol=0)
        return
    want = np.asarray(jie.SapiensEncoder(**VIT).apply({"params": params}, jnp.asarray(img)))
    diff, noise = np.abs(got - want), np.abs(want - want32)
    assert diff.mean() <= 2 * noise.mean() and diff.max() <= 2 * noise.max(), \
        (diff.mean(), noise.mean(), diff.max(), noise.max())


@pytest.mark.parametrize("size", [(64, 64), (40, 56)])
def test_image_feature_matches_jax(size):
    """8x8 token grid -> bilinear to the image size (upsampling; 40x56 is
    not a multiple of the grid) + RGB."""
    rng = np.random.RandomState(13)
    rgb = rng.rand(1, 2, 3, *size).astype(np.float32)
    tokens = rng.randn(1, 2, 64, 48).astype(np.float32)
    jmod = jie.ImageFeature(token_dim=48)
    params = random_params(jmod, 14, jnp.asarray(rgb), jnp.asarray(tokens))
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(rgb), jnp.asarray(tokens)))
    with torch.no_grad():
        got = load_flax(tie.ImageFeature(48), params)(t(rgb), t(tokens)).numpy()
    assert got.shape == (1, 2, 128) + size
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_triplane_positional_embedding_matches_jax():
    planes = np.random.RandomState(15).randn(2, 3, 8, 4, 4).astype(np.float32)
    jmod = jtok.TriplanePositionalEmbedding(num_channels=8, plane_size=4)
    params = random_params(jmod, 16, 2, jnp.asarray(planes))
    want = np.asarray(jmod.apply({"params": params}, 2, jnp.asarray(planes)))
    got = load_flax(ttok.TriplanePositionalEmbedding(8, 4), params)(2, t(planes))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("size_in", [16, 32])
def test_resnet_block_fc_matches_jax(size_in):
    x = np.random.RandomState(17).randn(2, 30, size_in).astype(np.float32)
    jmod = jte.ResnetBlockFC(16)
    params = random_params(jmod, 18, jnp.asarray(x))
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = load_flax(tte.ResnetBlockFC(size_in, 16), params)(t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


ENC = dict(triplane_resolution=8, feature_dim=32, smpl_token_len=8, smpl_token_dim=32,
           smplx_transformer_layers=1, smplx_transformer_head_dim=8,
           smplx_transformer_num_heads=2, image_feature_dim=48)


@pytest.mark.parametrize("gt_params", [True, False])
def test_smplx_triplane_encoder_matches_jax(gt_params):
    """With ground-truth SMPL-X params (the test/predict path) and with the
    predicted ones; every output compared."""
    B, T, H, W = 1, 2, 32, 32
    jmodel = jsmplx.synthetic_model(seed=0, num_verts=300)
    nverts = 300 + np.asarray(jmodel.faces).shape[0]
    batch = make_batch(B, T, (H, W), seed=19)
    rng = np.random.RandomState(20)
    tokens = rng.randn(B, T, 64, 48).astype(np.float32)
    feats = rng.randn(B * T, 128, H, W).astype(np.float32)
    smpl = batch.smpl_parms if gt_params else None
    jmod = jte.SMPLXTriplaneEncoder(num_verts=nverts, **ENC)
    jargs = (jmodel, jnp.asarray(tokens), {k: jnp.asarray(v) for k, v in batch.cam_parms.items()},
             None if smpl is None else {k: jnp.asarray(v) for k, v in smpl.items()},
             jnp.asarray(feats))
    params = random_params(jmod, 21, *jargs)
    want = jmod.apply({"params": params}, *jargs)
    tmod = load_flax(tte.SMPLXTriplaneEncoder(nverts, **ENC), params)
    tmodel = tsmplx.as_tensors(tsmplx.synthetic_model(seed=0, num_verts=300), "cpu")
    with torch.no_grad():
        got = tmod(tmodel, t(tokens), {k: t(v) for k, v in batch.cam_parms.items()},
                   None if smpl is None else {k: t(v) for k, v in smpl.items()}, t(feats))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4, rtol=0)
    assert set(got[2]) == set(want[2])
    for k in want[2]:
        np.testing.assert_allclose(got[2][k].numpy(), np.asarray(want[2][k]), atol=1e-4,
                                   rtol=0, err_msg=k)
    assert np.abs(np.asarray(want[0])).max() > 0


def test_encoder_upsample_path_raises():
    """The encoder-side upsample path (upsample_triplane_encoder, refused
    before it was ported) builds and equals the JAX encoder's: pooling and
    the scatter mean at 3R = 24^2, then the TriplaneDownsampler back to R."""
    B, T, H, W = 1, 1, 32, 32
    jmodel = jsmplx.synthetic_model(seed=0, num_verts=300)
    nverts = 300 + np.asarray(jmodel.faces).shape[0]
    batch = make_batch(B, T, (H, W), seed=27)
    tokens = np.random.RandomState(28).randn(B, T, 64, 48).astype(np.float32)
    feats = np.random.RandomState(29).randn(B * T, 128, H, W).astype(np.float32)
    jmod = jte.SMPLXTriplaneEncoder(num_verts=nverts, upsample_triplane=True, **ENC)
    jargs = (jmodel, jnp.asarray(tokens), {k: jnp.asarray(v) for k, v in batch.cam_parms.items()},
             {k: jnp.asarray(v) for k, v in batch.smpl_parms.items()}, jnp.asarray(feats))
    params = random_params(jmod, 30, *jargs)
    assert "triplane_downsampler" in params
    fast = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    fwd = jax.jit(lambda p, *a: jmod.apply({"params": p}, jmodel, *a))
    want = fwd.lower(params, *jargs[1:]).compile(compiler_options=fast)(params, *jargs[1:])
    tmod = load_flax(tte.SMPLXTriplaneEncoder(nverts, upsample_triplane=True, **ENC), params)
    tmodel = tsmplx.as_tensors(tsmplx.synthetic_model(seed=0, num_verts=300), "cpu")
    with torch.no_grad():
        got = tmod(tmodel, t(tokens), {k: t(v) for k, v in batch.cam_parms.items()},
                   {k: t(v) for k, v in batch.smpl_parms.items()}, t(feats))
    assert got[0].shape == (B, T, 3, 32, 8, 8)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4, rtol=0)
    assert np.abs(np.asarray(want[0])).max() > 0


def test_fusion_network_matches_jax():
    rng = np.random.RandomState(22)
    planes = rng.randn(1, 2, 3, 32, 8, 8).astype(np.float32)
    img = rng.randn(1, 2, 64, 48).astype(np.float32)
    smpl = rng.randn(1, 2, 32, 8).astype(np.float32)
    kw = dict(triplane_resolution=8, feature_dim=32, image_feature_dim=48, layers=1,
              head_dim=8, heads=2)
    jmod = jfusion.FeatureFusionNetwork(**kw)
    args = (jnp.asarray(planes), jnp.asarray(img), jnp.asarray(smpl))
    params = random_params(jmod, 23, *args)
    want = jmod.apply({"params": params}, *args)
    with torch.no_grad():
        got = load_flax(tfusion.FeatureFusionNetwork(**kw), params)(t(planes), t(img), t(smpl))
    assert got[0].shape == (1, 2, 32, 192) and got[1].shape == (1, 2, 32, 8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_dense_upsampler_poly_matches_jax():
    """The default form's upsampler: dense, GroupNorm, upconv='poly' on the
    JAX side; the port's dilated up-convolution computes the same function."""
    B, C, R = 1, 32, 8
    planes = np.random.RandomState(24).randn(B, 3, C, R, R).astype(np.float32)
    jmod = jup.TriplaneUpsampler(feature_dim=C, num_blocks=2, channels_last=True,
                                 upconv="poly", norm_mode="group")
    params = random_params(jmod, 25, jnp.asarray(planes))
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(planes)))
    with torch.no_grad():
        got = load_flax(tup.TriplaneUpsampler(C, 2, norm_mode="group"), params)(t(planes))
    assert got.shape == (B, 3, 4 * R, 4 * R, C)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_image_losses_match_jax():
    rng = np.random.RandomState(26)
    a = rng.rand(2, 3, 24, 20, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*a.shape), 0, 1).astype(np.float32)
    for jf, tf in ((jloss.l1_loss, tloss.l1_loss), (jloss.ssim, tloss.ssim),
                   (jloss.psnr, tloss.psnr)):
        np.testing.assert_allclose(float(tf(t(a), t(b))), float(jf(jnp.asarray(a), jnp.asarray(b))),
                                   rtol=1e-5, err_msg=jf.__name__)


def test_smplx_param_loss_matches_jax():
    pred = make_batch(2, 3, (16, 16), seed=27).smpl_parms
    gt = make_batch(2, 3, (16, 16), seed=28).smpl_parms
    want_total, want = jloss.smplx_param_loss({k: jnp.asarray(v) for k, v in pred.items()},
                                              {k: jnp.asarray(v) for k, v in gt.items()})
    got_total, got = tloss.smplx_param_loss({k: t(v) for k, v in pred.items()},
                                            {k: t(v) for k, v in gt.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(got_total), float(want_total), rtol=1e-5)


def test_synthetic_batch_matches_jax():
    """The port's own copy of make_batch draws the JAX package's numbers."""
    from audio_motion_avatar_tpu.data.synthetic import make_batch as jmake_batch
    a = jmake_batch(2, 3, (16, 24), seed=29, with_audio=True, audio_dim=8)
    b = make_batch(2, 3, (16, 24), seed=29, with_audio=True, audio_dim=8)
    np.testing.assert_array_equal(b.video, a.video)
    np.testing.assert_array_equal(b.audio_features, a.audio_features)
    for d_a, d_b in ((a.smpl_parms, b.smpl_parms), (a.cam_parms, b.cam_parms)):
        assert set(d_a) == set(d_b)
        for k in d_a:
            np.testing.assert_array_equal(d_b[k], d_a[k], err_msg=k)
