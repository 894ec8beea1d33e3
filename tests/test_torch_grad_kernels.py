"""The backward kernels' plain versions and their autograd Functions, on
the CPU, against the JAX package.

- attention_bwd_plain (kernel A-bwd's plain version) against jax.vjp of the
  JAX package's dense attention chain (models/ptv3.py: logits of q / sqrt(D),
  masked logits replaced by the dtype's minimum, softmax, P V), with
  Sq != Skv, ragged lengths and a key mask with an all-masked row: 1e-5
  in fp32.
- composite_tiles_bwd_plain (K2's plain version) against the TPU kernel
  `_composite_tiles_bwd_pallas` run in interpret mode and against
  `_composite_tiles_bwd_xla` (jax.vjp of the XLA twin), at rtol 1e-4 and
  atol 1e-5, the JAX package's own tolerance (tests/test_splat_pallas.py).
- AttentionFunction and CompositeTiles under torch.autograd.gradcheck
  (its fast mode: random projections of the Jacobian) in fp64 at toy size, and the model code routing through them under
  autograd (and not without it).
- The kernel calls of a tiny train step of each stage, remat recompute
  included, against the count chip_smoke.py expects of a configuration.
- The losses' gradients (SSIM, the clamped geodesic pose loss) against
  jax.grad.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from audio_motion_avatar_tpu.ops import splat_pallas as jsp

import chip_smoke
from audio_motion_avatar_tpu_torch.data.synthetic import make_batch, to_device
from audio_motion_avatar_tpu_torch.models.config import AvatarConfig
from audio_motion_avatar_tpu_torch.models.transformer import head_attention
from audio_motion_avatar_tpu_torch.ops import attention as at
from audio_motion_avatar_tpu_torch.ops import splat_tiles as st
from audio_motion_avatar_tpu_torch.ops import smplx as tsmplx
from audio_motion_avatar_tpu_torch.ops import winograd as wg
from audio_motion_avatar_tpu_torch.ops.cameras import make_camera
from audio_motion_avatar_tpu_torch.ops.splat import (Projected, activate_opacity,
                                                     activate_scales, project_gaussians)
from audio_motion_avatar_tpu_torch.train import build_trainer
from torch_parity import one_torch_thread  # noqa: F401


def jax_dense_attention(q, k, v, mask):
    """The JAX package's dense chain (models/ptv3.py _PatchAttention)."""
    D = q.shape[-1]
    logits = jnp.einsum("ghqd,ghkd->ghqk", q / jnp.sqrt(D).astype(q.dtype), k)
    if mask is not None:
        logits = jnp.where(mask[:, None, None, :], logits, jnp.finfo(logits.dtype).min)
    return jnp.einsum("ghqk,ghkd->ghqd", jax.nn.softmax(logits, axis=-1), v)


@pytest.mark.parametrize("B,H,Sq,Skv,masked", [
    (2, 2, 7, 13, False),     # Sq != Skv
    (1, 3, 77, 77, False),    # a ragged length
    (2, 2, 30, 45, True),     # a key mask; the second batch entry all masked
])
def test_attention_bwd_plain_matches_jax_vjp(B, H, Sq, Skv, masked):
    rng = np.random.RandomState(Sq)
    q, dout = (rng.randn(B, H, Sq, 16).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, H, Skv, 16).astype(np.float32) for _ in range(2))
    mask = None
    if masked:
        mask = np.zeros((B, Skv), bool)
        mask[0, :Skv // 3] = True
    jm = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda a, b, c: jax_dense_attention(a, b, c, jm),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    tm = None if mask is None else torch.tensor(mask)
    got = at.attention_bwd_plain(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                 16 ** -0.5, tm, torch.tensor(dout))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("B,H,Sq", [(2, 8, 6304), (2, 8, 3152), (1, 8, 80), (59, 4, 512),
                                     (1, 1, 1)])
def test_attention_bwd_scratch_covers_the_kernels_tiles(B, H, Sq):
    """A-bwd's launch plan: its per-row scratch covers every 64-query tile
    the dK / dV blocks stream and every 128-query dQ block, padded to whole
    blocks."""
    rows = at.attention_bwd_scratch(B, H, Sq)
    assert rows[0] == B * H and rows[2] == 4
    assert rows[1] % at.BWD_BLOCK == 0 and Sq <= rows[1] < Sq + at.BWD_BLOCK
    assert -(-Sq // 64) * 64 <= rows[1]


def test_kernel_rounding_reference():
    """chip_smoke.kernel_rounding, the CPU yardstick for the bf16 train steps
    on the kernels: with bf16 operands its attention and backward round
    where kernels A and A-bwd do, so they move off the fp32 plain versions
    by that rounding and no more (ops/attention.excess_error <= 1, the
    kernels' own rule); AttentionFunction on the CPU goes through them; fp32
    operands keep the plain versions, which come back after it."""
    rng = np.random.RandomState(5)
    B, H, Sq, Skv = 2, 2, 40, 70
    q, dout = (torch.tensor(rng.randn(B, H, Sq, 64).astype(np.float32)) for _ in range(2))
    k, v = (torch.tensor(rng.randn(B, H, Skv, 64).astype(np.float32)) for _ in range(2))
    mask = torch.ones(B, Skv, dtype=torch.bool)
    mask[1, 45:] = False
    scale = 64 ** -0.5
    plain, plain_bwd = at.attention_plain, at.attention_bwd_plain
    qb, kb, vb, gb = (t.bfloat16() for t in (q, k, v, dout))
    f32 = [t.float() for t in (qb, kb, vb)]
    want = [plain(*f32, scale, mask)] + list(plain_bwd(*f32, scale, mask, gb.float()))
    with chip_smoke.kernel_rounding():
        assert torch.equal(at.attention_plain(q, k, v, scale, mask), plain(q, k, v, scale, mask))
        got = [at.attention_plain(qb, kb, vb, scale, mask)] + \
            list(at.attention_bwd_plain(qb, kb, vb, scale, mask, gb))
        qa, ka, va = (t.clone().requires_grad_(True) for t in (qb, kb, vb))
        out = at.AttentionFunction.apply(qa, ka, va, scale, mask)
        out.backward(gb)
    assert at.attention_plain is plain and at.attention_bwd_plain is plain_bwd
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        assert at.excess_error(g, w) <= 1.0, name
    assert not torch.equal(got[0], plain(qb, kb, vb, scale, mask))
    assert not torch.equal(got[1], plain_bwd(qb, kb, vb, scale, mask, gb)[0])
    for name, g, w in zip(("out", "dq", "dk", "dv"), (out, qa.grad, ka.grad, va.grad), got):
        assert torch.equal(g, w), name


def _packed_views(F=2, N=150, W=48, H=32, K=70, seed=3):
    """F views of seeded gaussians binned and packed as the renderer does:
    (F * T, 9, K) with K above K2's 64-slot chunk, and tx, T."""
    rng = np.random.RandomState(seed)

    def r(*shape, s=1.0):
        return torch.tensor((rng.randn(*shape) * s).astype(np.float32))

    Km = torch.tensor([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]])
    E = torch.eye(4).repeat(F, 1, 1)
    E[:, 2, 3] = torch.tensor([2.0, 2.6][:F])
    proj = project_gaussians(r(F, N, 3, s=0.3), r(F, N, 4), activate_scales(r(F, N, 3, s=0.3) + 1),
                             activate_opacity(r(F, N)), torch.rand(F, N, 3),
                             make_camera(Km.expand(F, 3, 3), E, W, H))
    packed = torch.cat([st.pack_tile_params(Projected(*(a[f] for a in proj)), W, H, K, 4)
                        for f in range(F)])
    return packed, W // 16, (W // 16) * (H // 16)


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
def test_tile_bwd_plain_matches_jax(reference):
    packed, tx, T = _packed_views()
    g = np.random.RandomState(4).randn(packed.shape[0], 256, 3).astype(np.float32)
    p = packed.numpy()
    assert (p[:, 5] > 0).sum(1).max() > 64        # a tile with slots in two chunks
    if reference == "pallas_interpret":
        with pltpu.force_tpu_interpret_mode():
            want = jsp._composite_tiles_bwd_pallas(jnp.asarray(p), jnp.asarray(g), tx, T)
    else:
        tid = np.arange(p.shape[0]) % T
        origin = np.stack([(tid % tx) * 16, (tid // tx) * 16], 1).astype(np.float32)
        want = jsp._composite_tiles_bwd_xla(jnp.asarray(p), jnp.asarray(origin), jnp.asarray(g))
    got = st.composite_tiles_bwd_plain(packed, torch.tensor(g), tx, T).numpy()
    want = np.asarray(want)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _toy_tiles(T=2, K=5, tx=2, seed=5):
    """Toy tile params away from every threshold of the blend (alpha well
    inside (1/255, 0.99), pixels off the gaussian centres, colours inside
    (0, 1)), fp64, so that finite differences see a smooth function."""
    rng = np.random.RandomState(seed)
    p = np.zeros((T, 9, K))
    tid = np.arange(T)
    p[:, 0] = ((tid % tx) * 16)[:, None] + rng.uniform(3.3, 12.7, (T, K))
    p[:, 1] = ((tid // tx) * 16)[:, None] + rng.uniform(3.3, 12.7, (T, K))
    p[:, 2] = rng.uniform(0.02, 0.05, (T, K))
    p[:, 4] = rng.uniform(0.02, 0.05, (T, K))
    p[:, 3] = rng.uniform(-0.01, 0.01, (T, K))
    p[:, 5] = rng.uniform(0.3, 0.6, (T, K))
    p[:, 6:9] = rng.uniform(0.2, 0.8, (T, 3, K))
    return torch.tensor(p)


def test_composite_tiles_function_gradcheck():
    x = _toy_tiles().requires_grad_(True)
    assert torch.autograd.gradcheck(lambda t: st.CompositeTiles.apply(t, 2, 2), (x,),
                                    eps=1e-6, atol=1e-5, fast_mode=True)


def test_attention_function_gradcheck():
    rng = torch.Generator().manual_seed(6)
    q = torch.randn(2, 2, 5, 4, dtype=torch.float64, generator=rng, requires_grad=True)
    k = torch.randn(2, 2, 7, 4, dtype=torch.float64, generator=rng, requires_grad=True)
    v = torch.randn(2, 2, 7, 4, dtype=torch.float64, generator=rng, requires_grad=True)
    mask = torch.ones(2, 7, dtype=torch.bool)
    mask[0, 4:] = False
    mask[1] = False
    for m in (None, mask):
        assert torch.autograd.gradcheck(
            lambda a, b, c: at.AttentionFunction.apply(a, b, c, 0.5, m), (q, k, v),
            fast_mode=True)


def test_model_code_routes_through_the_functions():
    """Under autograd a 64-wide head attention and the tile composite run
    through their Functions; without autograd they do not."""
    q = torch.randn(1, 2, 5, 64, requires_grad=True)
    out = head_attention(q, q, q, 0.125)
    assert type(out.grad_fn).__name__ == "AttentionFunctionBackward"
    with torch.no_grad():
        assert torch.equal(head_attention(q, q, q, 0.125), out.detach())
    x = _toy_tiles().float().requires_grad_(True)
    assert type(st.composite(x, 2, 2).grad_fn).__name__ == "CompositeTilesBackward"
    with torch.no_grad():
        assert st.composite(x, 2, 2).grad_fn is None


def _kernel_calls(monkeypatch):
    """Count the plain versions' calls, which stand in for the kernels'
    launches on the CPU."""
    calls = {"attention": 0, "attention_bwd": 0, "composite_tiles": 0,
             "composite_tiles_bwd": 0, "winograd_conv3x3": 0,
             "winograd_conv3x3_gn_relu": 0}
    for mod, name, key in ((at, "attention_plain", "attention"),
                           (at, "attention_bwd_plain", "attention_bwd"),
                           (st, "composite_tiles_plain", "composite_tiles"),
                           (st, "composite_tiles_bwd_plain", "composite_tiles_bwd"),
                           (wg, "winograd_conv3x3_plain", "winograd_conv3x3"),
                           (wg, "winograd_conv3x3_gn_relu_plain", "winograd_conv3x3_gn_relu")):
        def counted(*a, _f=getattr(mod, name), _k=key, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("stage", [1, 2])
def test_train_step_kernel_calls_match_the_expected_count(monkeypatch, stage):
    """The count chip_smoke.py holds the card's launches to, remat recompute
    included, on a tiny configuration with 64-wide predictor, fusion, audio
    and PTv3 decoder heads."""
    cfg = dataclasses.replace(
        AvatarConfig.tiny(image_size=(32, 32)), smplx_transformer_head_dim=64,
        cross_transformer_head_dim=64, audio_transformer_head_dim=64,
        ptv3_dec_channels=(128,), ptv3_dec_heads=(2,), triplane_output_frames=3)
    tr = build_trainer(stage, cfg, device="cpu",
                       smplx_model=tsmplx.synthetic_model(seed=0, num_verts=300))
    if stage == 1:
        B, T_in, T_out = 1, 1, 3
        other = make_batch(B, T_out, (32, 32), seed=1)
    else:
        B, T_in, T_out = 1, cfg.triplane_input_frames, cfg.triplane_output_frames
        other = make_batch(B, T_out, (32, 32), seed=1, with_audio=True,
                           audio_dim=cfg.audio_feature_dim)
    calls = _kernel_calls(monkeypatch)
    tr.step(to_device(make_batch(B, T_in, (32, 32), seed=0), "cpu"), to_device(other, "cpu"))
    want = chip_smoke.train_launches(cfg, stage, B, T_in, T_out)
    assert calls == want, (calls, want)


@pytest.mark.parametrize("stage,conv", [(1, "winograd_gn"), (2, "winograd")])
def test_train_step_winograd_launches_match_the_expected_count(monkeypatch, stage, conv):
    """The same count with the Winograd upsampler convs at 128 channels (the
    kernels' width): K9b on every stage-1 dense conv (GroupNorm fused), K9a
    on stage 2's, each frame chunk's again in its remat recompute; their
    backward is the direct conv's."""
    cfg = dataclasses.replace(AvatarConfig.tiny(image_size=(32, 32)), triplane_feature_dim=128,
                              smpl_token_dim=128, upsampler_conv=conv, triplane_output_frames=3)
    tr = build_trainer(stage, cfg, device="cpu",
                       smplx_model=tsmplx.synthetic_model(seed=0, num_verts=300))
    B, T_in, T_out = (1, 1, 3) if stage == 1 else (1, cfg.triplane_input_frames, 3)
    other = make_batch(B, T_out, (32, 32), seed=1, with_audio=stage == 2,
                       audio_dim=cfg.audio_feature_dim)
    calls = _kernel_calls(monkeypatch)
    m = tr.step(to_device(make_batch(B, T_in, (32, 32), seed=0), "cpu"), to_device(other, "cpu"))
    want = chip_smoke.train_launches(cfg, stage, B, T_in, T_out)
    assert calls == want, (calls, want)
    key = "winograd_conv3x3_gn_relu" if conv == "winograd_gn" else "winograd_conv3x3"
    assert want[key] > 0 and np.isfinite(m["loss"])


def test_loss_gradients_match_jax():
    """utils/losses under autograd against jax.grad: SSIM, and the geodesic
    pose loss with a rotation equal to its target (cos clamped at 0.999: no
    gradient), a zero axis-angle (the small-angle branch) and a near-half
    turn (cos near the -0.999 clamp); 1e-5."""
    from audio_motion_avatar_tpu.utils import losses as jl
    from audio_motion_avatar_tpu_torch.utils import losses as tl

    rng = np.random.RandomState(8)
    a = rng.rand(1, 2, 20, 18, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*a.shape), 0, 1).astype(np.float32)
    want = jax.grad(lambda x: jl.ssim(x, jnp.asarray(b)))(jnp.asarray(a))
    x = torch.tensor(a, requires_grad=True)
    tl.ssim(x, torch.tensor(b)).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)

    gt = rng.randn(6, 3).astype(np.float32) * 0.5
    pred = gt + rng.randn(6, 3).astype(np.float32) * 0.3
    pred[0] = gt[0]                                  # clamped at cos 0.999
    pred[1], gt[1] = 0.0, rng.randn(3) * 0.2         # zero axis-angle
    gt[2] = np.array([0.0, 0.0, 0.0])
    pred[2] = np.array([3.1, 0.05, 0.0])             # near a half turn
    for p_, g_ in ((pred, gt), (gt, pred)):
        want = jax.grad(lambda x: jl.rotation_geodesic_loss(x, jnp.asarray(g_)))(jnp.asarray(p_))
        x = torch.tensor(p_, requires_grad=True)
        tl.rotation_geodesic_loss(x, torch.tensor(g_)).backward()
        assert np.isfinite(x.grad.numpy()).all()
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
