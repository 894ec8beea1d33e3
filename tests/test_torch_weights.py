"""`weights.params_from_flax`: the JAX models' parameter trees -> the
port's state_dicts.

The trees are the JAX tiny models' own (traced with eval_shape, drawn from
a numpy seed): the serving rollout's (the stage-2 model's serving parts)
and the stage-1 TriplaneGaussianAvatar's. Loading with strict=True proves
that every parameter of the port has a key and no key is left over; the
layout rules are checked value by value on one leaf of each kind. The
whole trained stage-2 tree is loaded strictly in
tests/test_torch_reconstruct.py.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_motion_avatar_tpu.data.synthetic import make_batch
from audio_motion_avatar_tpu.ops import smplx as jax_smplx

from audio_motion_avatar_tpu_torch.models.audio_avatar import AudioDrivenAvatar
from audio_motion_avatar_tpu_torch.models.config import AvatarConfig, serving_config
from audio_motion_avatar_tpu_torch.models.avatar import TriplaneGaussianAvatar
from audio_motion_avatar_tpu_torch.weights import params_from_flax
from torch_parity import jax_serving_avatar, random_params

OVERRIDES = dict(num_upsample_blocks=2, upsampler_sparse_max_tiles=3,
                 upsampler_norm="affine")


@pytest.fixture(scope="module")
def tree():
    cfg, model, chunk = jax_serving_avatar(
        jax_smplx.synthetic_model(seed=0, num_verts=300), **OVERRIDES)
    rng = np.random.RandomState(0)
    C, L, T_in, T_out = (cfg.triplane_feature_dim, cfg.smpl_token_len,
                         cfg.triplane_input_frames, cfg.triplane_output_frames)
    tri = rng.randn(1, T_in, C, 3 * cfg.triplane_resolution ** 2).astype(np.float32)
    smpl = rng.randn(1, T_in, C, L).astype(np.float32)
    audio = rng.randn(1, T_out, cfg.audio_feature_dim).astype(np.float32)
    cams = {k: jnp.asarray(v) for k, v in
            make_batch(1, T_out, cfg.image_size, seed=3).cam_parms.items()}
    return random_params(model, 1, tri, smpl, audio, cams,
                         method=lambda m, *a: chunk(m, *a, render=False))


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.fixture(scope="module")
def stage1_tree():
    from audio_motion_avatar_tpu.models.avatar import TriplaneGaussianAvatar as JaxAvatar
    from audio_motion_avatar_tpu.models.config import AvatarConfig as JaxConfig
    from audio_motion_avatar_tpu.models.ptv3 import build_point_refiner
    from audio_motion_avatar_tpu.models.renderer import build_renderer_statics
    cfg = JaxConfig.tiny(image_size=(32, 32))
    body = jax_smplx.synthetic_model(seed=0, num_verts=300)
    statics = build_renderer_statics(body, subdivide_steps=cfg.subdivide_steps)
    model = JaxAvatar(cfg=cfg, num_verts_encoder=300 + np.asarray(body.faces).shape[0],
                      point_refiner=build_point_refiner(cfg))
    b = make_batch(1, 1, cfg.image_size, seed=0)
    return random_params(model, 2, statics, jnp.asarray(b.video), b.smpl_parms,
                         {k: jnp.asarray(v) for k, v in b.cam_parms.items()})


def test_maps_every_leaf_the_rollout_reads(tree):
    """The serving rollout's tree (audio net, shared decoder, renderer,
    refiner) maps one to one onto the serving-only model."""
    sd = params_from_flax(tree)
    model = AudioDrivenAvatar(serving_config(AvatarConfig.tiny(image_size=(32, 32)),
                                             **OVERRIDES))
    model.load_state_dict(sd, strict=True)      # no missing, no unexpected key
    assert len(sd) == len(list(_leaves(tree))) == len(model.state_dict())
    assert sum(v.numel() for v in sd.values()) == \
        sum(p.numel() for p in model.parameters())


def test_layout_rules(tree):
    """One leaf of each rule: Dense (in, out) -> Linear (out, in); conv HWIO
    -> OIHW; MHA (C, H, D) / (H, D, C); (H, D) biases; time_kernel (3, C, T)
    -> (3C, 1, T, 1, 1); LayerNorm scale -> weight."""
    sd = params_from_flax(tree)
    at = tree["audio_triplane"]
    tg = tree["triplane_gaussian"]
    rd = tg["renderer"]
    blk = at["transformer"]["block_0"]
    np.testing.assert_array_equal(sd["audio_triplane.transformer.proj_in.weight"],
                                  at["transformer"]["proj_in"]["kernel"].T)
    np.testing.assert_array_equal(sd["audio_triplane.transformer.block_0.norm1.weight"],
                                  blk["norm1"]["scale"])
    np.testing.assert_array_equal(sd["audio_triplane.transformer.block_0.attn1.q.weight"],
                                  blk["attn1"]["q"]["kernel"].T)
    tk = at["triplane_motion_encoder"]["time_kernel"]
    P, C, T = tk.shape
    np.testing.assert_array_equal(sd["audio_triplane.triplane_motion_encoder.weight"],
                                  tk.reshape(P * C, 1, T, 1, 1))
    conv = rd["upsampler"]["up_0"]["res"]["conv1"]["kernel"]
    np.testing.assert_array_equal(sd["triplane_gaussian.renderer.upsampler.up_0.res.conv1.weight"],
                                  conv.transpose(3, 2, 0, 1))
    up0 = rd["upsampler"]["up_0"]
    np.testing.assert_array_equal(sd["triplane_gaussian.renderer.upsampler.up_0.conv_weight"],
                                  up0["conv_kernel"].transpose(3, 2, 0, 1))
    attn = tree["point_refiner"]["unet"]["enc0_b0"]["attn"]
    Cq, H, D = attn["query"]["kernel"].shape
    np.testing.assert_array_equal(sd["triplane_gaussian.renderer.point_refiner.unet.enc0_b0.attn.query.weight"],
                                  attn["query"]["kernel"].reshape(Cq, H * D).T)
    np.testing.assert_array_equal(sd["triplane_gaussian.renderer.point_refiner.unet.enc0_b0.attn.query.bias"],
                                  attn["query"]["bias"].reshape(-1))
    np.testing.assert_array_equal(sd["triplane_gaussian.renderer.point_refiner.unet.enc0_b0.attn.out.weight"],
                                  attn["out"]["kernel"].reshape(H * D, -1).T)
    dec = tg["smplx_triplane_encoder"]["smpl_decoder"]
    np.testing.assert_array_equal(
        sd["triplane_gaussian.smplx_triplane_encoder.smpl_decoder.transl.weight"],
        dec["transl"]["kernel"].T)
    assert all(v.dtype == torch.float32 and v.is_contiguous() for v in sd.values())


def test_maps_every_leaf_of_the_stage1_model(stage1_tree):
    sd = params_from_flax(stage1_tree)
    model = TriplaneGaussianAvatar(AvatarConfig.tiny(image_size=(32, 32)), 300 + 512)
    model.load_state_dict(sd, strict=True)
    assert len(sd) == len(list(_leaves(stage1_tree))) == len(model.state_dict())


def test_stage1_layout_rules(stage1_tree):
    """Embed `embedding` -> weight; raw params (pos_embed, smpl_tokens, the
    tokenizer's embeddings) as they are; the patch-embedding conv HWIO ->
    OIHW; the point refiner from the tree's top level into the renderer."""
    sd = params_from_flax(stage1_tree)
    enc = stage1_tree["smplx_triplane_encoder"]
    vit = stage1_tree["sapiens_encoder"]["vit"]
    np.testing.assert_array_equal(sd["smplx_triplane_encoder.vertex_emb.weight"],
                                  enc["vertex_emb"]["embedding"])
    np.testing.assert_array_equal(sd["smplx_triplane_encoder.smpl_tokens"], enc["smpl_tokens"])
    np.testing.assert_array_equal(sd["sapiens_encoder.vit.pos_embed"], vit["pos_embed"])
    np.testing.assert_array_equal(sd["sapiens_encoder.vit.patch_embed.weight"],
                                  vit["patch_embed"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["fusion_network.triplane_tokenizer.embeddings"],
        stage1_tree["fusion_network"]["triplane_tokenizer"]["embeddings"])
    np.testing.assert_array_equal(
        sd["renderer.point_refiner.unet.enc0_b0.attn.query.bias"],
        stage1_tree["point_refiner"]["unet"]["enc0_b0"]["attn"]["query"]["bias"].reshape(-1))


@pytest.mark.parametrize("where", ["subtree", "leaf"])
def test_raises_on_unknown_key(tree, where):
    bad = copy.deepcopy(tree)
    if where == "subtree":
        bad["extra_head"] = {"kernel": np.zeros((2, 2), np.float32)}
    else:
        bad["audio_triplane"]["transformer"]["proj_in"]["gamma"] = np.zeros(2, np.float32)
    with pytest.raises(KeyError):
        params_from_flax(bad)
