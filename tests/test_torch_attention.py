"""Attention in the PyTorch port against the JAX package on the CPU.

On CPU tensors the port's attention runs the plain version of kernel A
(`ops.attention.attention_plain`, fp32 logits and softmax) where the head
width is 64, and the dense chain elsewhere; the JAX modules run their dense
CPU paths (`Attention` at transformer.py:189-201, `_PatchAttention`'s flax
numerics). Same seeded weights on both sides, fp32; tolerance 1e-5 absolute
(the two frameworks sum the same products in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_motion_avatar_tpu.models.ptv3 import _PatchAttention as JaxPatchAttention
from audio_motion_avatar_tpu.models.transformer import Attention as JaxAttention

from audio_motion_avatar_tpu_torch.models.ptv3 import _PatchAttention
from audio_motion_avatar_tpu_torch.models.transformer import Attention
from audio_motion_avatar_tpu_torch.ops import attention as at
from torch_parity import load_flax, one_torch_thread, random_params, t  # noqa: F401

TOL = 1e-5


@pytest.mark.parametrize("head_dim,q_tail,ctx_len", [
    (64, None, None),     # self-attention at the kernel's head width
    (64, 12, None),       # q_tail: only the last 12 queries (the last block)
    (16, None, None),     # narrow heads: the dense chain
    (64, None, 1),        # one audio token: the exact single-key shortcut
    (64, None, 7),        # cross-attention over several keys
])
def test_attention_matches_jax(head_dim, q_tail, ctx_len):
    B, S, C, heads, C_ctx = 2, 40, 32, 2, 24
    rng = np.random.RandomState(head_dim + (q_tail or 0) + (ctx_len or 0))
    x = rng.randn(B, S, C).astype(np.float32)
    ctx = None if ctx_len is None else rng.randn(B, ctx_len, C_ctx).astype(np.float32)
    jmod = JaxAttention(heads=heads, head_dim=head_dim, out_dim=C,
                        context_dim=None if ctx is None else C_ctx, q_tail=q_tail)
    args = (jnp.asarray(x),) if ctx is None else (jnp.asarray(x), jnp.asarray(ctx))
    params = random_params(jmod, 1, *args)
    want = np.asarray(jmod.apply({"params": params}, *args))

    tmod = load_flax(Attention(C, heads, head_dim, C,
                               context_dim=None if ctx is None else C_ctx,
                               q_tail=q_tail), params)
    with torch.no_grad():
        got = tmod(t(x), None if ctx is None else t(ctx)).numpy()
    assert got.shape == want.shape == (B, q_tail or S, C)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("dim,heads", [(128, 2), (32, 2)])   # D = 64, D = 16
@pytest.mark.parametrize("masked", [False, True])
def test_patch_attention_matches_jax(dim, heads, masked):
    """Valid-first key masks as PTv3 builds them: one full patch, one cut
    short, one all padding (uniform weights on both sides)."""
    G, P = 3, 16
    rng = np.random.RandomState(dim + masked)
    hq = rng.randn(G, P, dim).astype(np.float32)
    mask = None
    if masked:
        valid = np.array([P, 5, 0])
        mask = np.arange(P)[None, :] < valid[:, None]
    jmod = JaxPatchAttention(dim=dim, heads=heads)
    jargs = (jnp.asarray(hq),) if mask is None else (jnp.asarray(hq), jnp.asarray(mask))
    params = random_params(jmod, 2, *jargs)
    want = np.asarray(jmod.apply({"params": params}, *jargs))

    tmod = load_flax(_PatchAttention(dim, heads), params)
    with torch.no_grad():
        got = tmod(t(hq), None if mask is None else torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_attention_plain_matches_numpy_reference():
    """Kernel A's plain version against softmax(q k^T s + mask) v written
    out in float64, with a ragged key mask (B, Skv)."""
    B, H, Sq, Skv, D = 2, 3, 9, 13, 64
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(B, H, s, D).astype(np.float32) for s in (Sq, Skv, Skv))
    mask = np.arange(Skv)[None, :] < np.array([Skv, 6])[:, None]
    scale = D ** -0.5
    logits = np.einsum("bhsd,bhtd->bhst", q, k).astype(np.float64) * scale
    logits = np.where(mask[:, None, None, :], logits, -np.inf)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    want = np.einsum("bhst,bhtd->bhsd", p / p.sum(-1, keepdims=True), v)
    got = at.attention(t(q), t(k), t(v), scale, torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_attention_wrapper_refuses_other_devices():
    """Only CPU tensors take the plain version; anything else is the
    kernel's or an error, never a silent fallback."""
    q = torch.zeros(1, 1, 4, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        at.attention(q, q, q, 0.125)
