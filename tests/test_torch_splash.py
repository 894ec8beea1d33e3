"""The audio self-attention's implementation names (`audio_attn_impl`).

The JAX package selects its audio self-attention kernel by name: the
stock flash kernel, its base-2 clone flash2, the stock splash kernel (K8s)
and its own serve / hpack kernels. All compute softmax((q scale) k^T) v
over the valid keys, kernel A's function, and the port routes every name
there. Here JAX's splash kernel, built as `Attention._splash` builds it
(FullMask per head, the sequence padded by its pad plan and masked by
segment ids, q pre-scaled; at D = 64 the scale 0.125 is a power of two) and
run in interpret mode, is held against the port's attention on the
'splash' route, both in fp32: max |diff| <= 1e-5 (the same function, sums
in another order). Also: the config accepts the five names and rejects
others, and a train step refuses the four forward-only ones.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_motion_avatar_tpu.models.transformer import Attention as JaxAttention

from audio_motion_avatar_tpu_torch.models.audio_avatar import AudioDrivenAvatar
from audio_motion_avatar_tpu_torch.models.config import AvatarConfig
from audio_motion_avatar_tpu_torch.models.transformer import (ATTN_IMPLS, Transformer1D,
                                                             linear, merge_heads,
                                                             split_heads)
from torch_parity import t


def _jax_splash(q, k, v, scale):
    """JAX's splash kernel as Attention._splash calls it, in interpret mode:
    (B, H, S, D) -> (B, H, S, D)."""
    from jax.experimental.pallas.ops.tpu.splash_attention import (
        splash_attention_kernel as sk, splash_attention_mask as sm)

    B, H, S, D = q.shape
    Sp, BQ = JaxAttention._pad_block(S, max_block=640)

    def pad(a):
        return jnp.pad(a, ((0, 0), (0, 0), (0, Sp - S), (0, 0)))

    seg = jnp.broadcast_to(jnp.where(jnp.arange(Sp) < S, 1, 2).astype(jnp.int32)[None], (B, Sp))
    mask = sm.MultiHeadMask([sm.FullMask((Sp, Sp)) for _ in range(H)])
    kernel = sk.make_splash_mha(mask=mask, head_shards=1, q_seq_shards=1,
                                block_sizes=sk.BlockSizes(block_q=BQ, block_kv=BQ,
                                                          block_kv_compute=BQ),
                                interpret=True)
    out = jax.vmap(lambda qb, kb, vb, s: kernel(qb * scale, kb, vb,
                                                segment_ids=sk.SegmentIds(q=s, kv=s)))(
        pad(q), pad(k), pad(v), seg)
    return out[:, :, :S]


def test_splash_route_matches_jax_splash_kernel():
    """H = 2, S = 300 (ragged: padded to 384 and masked), D = 64, fp32."""
    B, H, S, D = 2, 2, 300, 64
    block = Transformer1D(1, H, D, 128, attn_impl="splash").block_0
    assert block.attn1.q_tail is None
    x = t(np.random.RandomState(0).randn(B, S, H * D).astype(np.float32))
    attn = block.attn1
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for layer in (attn.q, attn.k, attn.v, attn.out):
            layer.weight.copy_(torch.randn(layer.weight.shape, generator=g) * 0.1)
        q, k, v = (split_heads(linear(x, layer, None), H) for layer in (attn.q, attn.k, attn.v))
        got = attn(x)
    want = _jax_splash(*(jnp.asarray(a.numpy()) for a in (q, k, v)), D ** -0.5)
    want = linear(merge_heads(t(want)), attn.out, None)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ATTN_IMPLS)
def test_config_accepts_the_jax_attention_names(name):
    cfg = dataclasses.replace(AvatarConfig.tiny(image_size=(32, 32)), audio_attn_impl=name)
    assert AudioDrivenAvatar(cfg).audio_triplane.transformer.attn_impl == name


def test_config_rejects_other_attention_names():
    cfg = dataclasses.replace(AvatarConfig.tiny(image_size=(32, 32)), audio_attn_impl="ring")
    with pytest.raises(ValueError, match="attn_impl"):
        AudioDrivenAvatar(cfg)


@pytest.mark.parametrize("name", ["flash2", "splash", "serve", "hpack"])
def test_train_step_refuses_forward_only_attention(name):
    from audio_motion_avatar_tpu_torch.train import build_trainer
    from audio_motion_avatar_tpu_torch.training import stage1, stage2
    cfg = dataclasses.replace(AvatarConfig.tiny(image_size=(32, 32)), audio_attn_impl=name)
    for make in (stage1.make_train_step, stage2.make_train_step):
        with pytest.raises(ValueError, match=f"audio_attn_impl={name}"):
            make(None, None, cfg)
    with pytest.raises(ValueError, match="audio_attn_impl"):
        build_trainer(2, cfg, device="cpu")
