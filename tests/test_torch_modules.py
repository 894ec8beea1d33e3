"""The PyTorch port's modules against the JAX package on the CPU, at tiny
sizes, with the same seeded weights and inputs on both sides (fp32).

Tolerances: 1e-5 absolute for single-stage geometry and the dilated
up-convolution, 1e-4 for the deep stacks (SMPL-X decoder, upsampler, PTv3,
the audio rollout), where the frameworks reassociate longer sums. The
host-side tables (synthetic SMPL-X arrays, subdivision, sub-selection) are
exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_motion_avatar_tpu.models import upsampler as jax_up
from audio_motion_avatar_tpu.models.audio_net import AudioTriplaneNet as JaxAudioNet
from audio_motion_avatar_tpu.models.config import AvatarConfig as JaxConfig
from audio_motion_avatar_tpu.models.ptv3 import build_point_refiner as jax_refiner
from audio_motion_avatar_tpu.models.smplx_decoder import SMPLXDecoder as JaxDecoder
from audio_motion_avatar_tpu.ops import rotations as jax_rot
from audio_motion_avatar_tpu.ops import smplx as jax_smplx
from audio_motion_avatar_tpu.ops import subdivision as jax_sub

from audio_motion_avatar_tpu_torch.models import upsampler as up
from audio_motion_avatar_tpu_torch.models.audio_net import AudioTriplaneNet
from audio_motion_avatar_tpu_torch.models.config import AvatarConfig
from audio_motion_avatar_tpu_torch.models.ptv3 import build_point_refiner
from audio_motion_avatar_tpu_torch.models.smplx_decoder import SMPLXDecoder
from audio_motion_avatar_tpu_torch.ops import rotations as rot
from audio_motion_avatar_tpu_torch.ops import smplx
from audio_motion_avatar_tpu_torch.ops import subdivision as sub
from torch_parity import load_flax, one_torch_thread, random_params, t  # noqa: F401


@pytest.mark.parametrize("num_verts", [300, 1000])
def test_synthetic_model_arrays_match_jax(num_verts):
    mine = smplx.synthetic_model(seed=3, num_verts=num_verts)
    ref = jax_smplx.synthetic_model(seed=3, num_verts=num_verts)
    for name in smplx.SmplxModel._fields:
        np.testing.assert_array_equal(np.asarray(getattr(mine, name)),
                                      np.asarray(getattr(ref, name)), err_msg=name)


def _pose_params(B, rng):
    def aa(*shape):
        return (0.4 * rng.randn(B, *shape)).astype(np.float32)
    return {"global_orient": aa(3), "body_pose": aa(21, 3), "betas": aa(10),
            "left_hand_pose": aa(15, 3), "right_hand_pose": aa(15, 3),
            "jaw_pose": aa(3), "leye_pose": aa(3), "reye_pose": aa(3),
            "expression": aa(10), "transl": aa(3)}


@pytest.mark.parametrize("flat_hand_mean", [False, True])
def test_smplx_forward_matches_jax(flat_hand_mean):
    model = smplx.synthetic_model(seed=0, num_verts=300)
    params = _pose_params(3, np.random.RandomState(1))
    want = jax_smplx.forward(jax_smplx.synthetic_model(seed=0, num_verts=300),
                             {k: jnp.asarray(v) for k, v in params.items()},
                             flat_hand_mean=flat_hand_mean, apply_transl=True)
    got = smplx.forward(smplx.as_tensors(model, "cpu"),
                        {k: t(v) for k, v in params.items()},
                        flat_hand_mean=flat_hand_mean, apply_transl=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_subdivision_matches_jax():
    model = smplx.synthetic_model(seed=0, num_verts=300)
    nv, faces = model.v_template.shape[0], model.faces
    mine, ref = sub.build_subdivision(nv, faces, 2), jax_sub.build_subdivision(nv, faces, 2)
    assert mine.num_verts == tuple(ref.num_verts)
    for a, b in zip(mine.edges + mine.faces, tuple(ref.edges) + tuple(ref.faces)):
        np.testing.assert_array_equal(a, np.asarray(b))
    verts = np.random.RandomState(2).randn(2, nv, 3).astype(np.float32)
    np.testing.assert_allclose(sub.apply_subdivision(t(verts), mine).numpy(),
                               np.asarray(jax_sub.apply_subdivision(jnp.asarray(verts), ref)),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(sub.fixed_subselect(mine.num_verts[-1], 3000, seed=0),
                                  jax_sub.fixed_subselect(ref.num_verts[-1], 3000, seed=0))


def test_rotations_match_jax():
    d6 = np.random.RandomState(4).randn(64, 6).astype(np.float32)
    np.testing.assert_allclose(rot.rotation_6d_to_matrix(t(d6)).numpy(),
                               np.asarray(jax_rot.rotation_6d_to_matrix(jnp.asarray(d6))),
                               atol=1e-6, rtol=0)
    aa = rot.rotation_6d_to_axis_angle(t(d6))
    np.testing.assert_allclose(aa.numpy(),
                               np.asarray(jax_rot.rotation_6d_to_axis_angle(jnp.asarray(d6))),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(rot.axis_angle_to_matrix(aa).numpy(),
                               np.asarray(jax_rot.axis_angle_to_matrix(jnp.asarray(aa.numpy()))),
                               atol=1e-6, rtol=0)


def test_smplx_decoder_matches_jax():
    C, L, B = 32, 8, 3
    tokens = np.random.RandomState(5).randn(B, C, L).astype(np.float32)
    jmod = JaxDecoder(token_dim=C, token_len=L)
    params = random_params(jmod, 6, jnp.asarray(tokens))
    want = jmod.apply({"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        got = load_flax(SMPLXDecoder(C, L), params)(t(tokens))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4,
                                   rtol=0, err_msg=k)


def test_dilated_upconv_matches_jax():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 5, 6, 8).astype(np.float32)
    w = rng.randn(3, 3, 8, 12).astype(np.float32) / 8          # HWIO
    b = rng.randn(12).astype(np.float32)
    want = jax_up._upsample2x_conv3x3_dilated(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = up.upsample2x_conv3x3_dilated(t(x), t(w.transpose(3, 2, 0, 1)), t(b))
    assert got.shape == (2, 10, 12, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("norm_mode", ["affine", "group"])
@pytest.mark.parametrize("sparse", [False, True])
def test_upsampler_matches_jax(norm_mode, sparse):
    """Two blocks, 8 -> 32 px planes. Sparse: the final level on the 16 px
    tiles the points cover (cap 3 of 4); only valid slots are compared,
    since invalid slots hold finite values no sampler reads."""
    B, C, R, N, cap = 1, 32, 8, 40, 3
    rng = np.random.RandomState(8)
    planes = rng.randn(B, 3, C, R, R).astype(np.float32)
    uv = np.clip(rng.randn(B, 3, N, 2) * 0.3 - 0.3, -1, 1).astype(np.float32)
    jmod = jax_up.TriplaneUpsampler(feature_dim=C, num_blocks=2, channels_last=True,
                                    sparse_final=sparse, sparse_max_tiles=cap,
                                    upconv="dilated", norm_mode=norm_mode)
    jargs = (jnp.asarray(planes), jnp.asarray(uv)) if sparse else (jnp.asarray(planes),)
    params = random_params(jmod, 9, *jargs)
    want = jmod.apply({"params": params}, *jargs)
    tmod = load_flax(up.TriplaneUpsampler(C, 2, sparse_final=sparse, sparse_max_tiles=cap,
                                          norm_mode=norm_mode), params)
    with torch.no_grad():
        got = tmod(t(planes), t(uv) if sparse else None)
    if not sparse:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
        return
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.slot.numpy(), np.asarray(want.slot))
    np.testing.assert_array_equal(got.sorted_ids.numpy(), np.asarray(want.sorted_ids))
    assert (got.grid, got.tile_px, got.res) == (want.grid, want.tile_px, want.res)
    assert valid.sum() > 0
    np.testing.assert_allclose(got.tiles.numpy()[valid], np.asarray(want.tiles)[valid],
                               atol=1e-4, rtol=0)


PTV3_D64 = dict(ptv3_enc_channels=(16, 128), ptv3_enc_depths=(1, 1),
                ptv3_enc_heads=(2, 2), ptv3_dec_channels=(128,),
                ptv3_dec_depths=(2,), ptv3_dec_heads=(2,))


@pytest.mark.parametrize("widths", ["tiny", "d64"])
def test_point_refiner_matches_jax(widths):
    """PTv3 over 150 points padded to 192 (patch 64): serialization ties,
    pooling, masked patches. 'd64' gives the second encoder stage and the
    decoder head width 64, the port's kernel-A path."""
    over = dict(gelu_approx=True, **(PTV3_D64 if widths == "d64" else {}))
    jcfg = dataclasses.replace(JaxConfig.tiny(), **over)
    cfg = dataclasses.replace(AvatarConfig.tiny(), **over)
    rng = np.random.RandomState(10)
    pts = (rng.randn(2, 150, 3) * 0.4).astype(np.float32)
    feats = rng.randn(2, 150, 3 * cfg.triplane_feature_dim).astype(np.float32)
    jmod = jax_refiner(jcfg)
    params = random_params(jmod, 11, jnp.asarray(pts), jnp.asarray(feats))
    want = jmod.apply({"params": params}, jnp.asarray(pts), jnp.asarray(feats))
    with torch.no_grad():
        got = load_flax(build_point_refiner(cfg), params)(t(pts), t(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("head_dim,heads", [(8, 2), (64, 2)])
def test_audio_triplane_net_matches_jax(head_dim, heads):
    """The 6-step AR rollout with the (new, last) re-encoding order."""
    kw = dict(feature_dim=32, triplane_resolution=4, smpl_token_len=8, input_frames=2,
              output_frames=6, layers=2, head_dim=head_dim, heads=heads,
              audio_feature_dim=16, gelu_approx=True)
    B, S = 2, 3 * 4 * 4
    rng = np.random.RandomState(12)
    audio = (rng.randn(B, 6, 16) * 0.5).astype(np.float32)
    tri = (rng.randn(B, 2, 32, S) * 0.5).astype(np.float32)
    smpl = (rng.randn(B, 2, 32, 8) * 0.5).astype(np.float32)
    jargs = tuple(jnp.asarray(a) for a in (audio, tri, smpl))
    jmod = JaxAudioNet(remat=False, **kw)
    params = random_params(jmod, 13, *jargs)
    want_tri, want_smpl = jmod.apply({"params": params}, *jargs)
    with torch.no_grad():
        got_tri, got_smpl = load_flax(AudioTriplaneNet(**kw), params)(t(audio), t(tri), t(smpl))
    np.testing.assert_allclose(got_tri.numpy(), np.asarray(want_tri), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_smpl.numpy(), np.asarray(want_smpl), atol=1e-4, rtol=0)
