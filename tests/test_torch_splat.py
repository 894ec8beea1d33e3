"""Port's serving splat (ops/splat.py, ops/splat_segmented.py) vs the JAX one.

The composite is kernel S's plain version (the wrapper takes it for CPU
tensors). The JAX side runs its segmented Pallas composite in interpret
mode, as tests/test_splat_pallas.py does. Tolerances: projection 1e-5
relative (same fp32 formulas); binning exact (same sort order); images
2e-5 absolute (sequential vs prefix-sum transmittance).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from audio_motion_avatar_tpu.ops import splat as jsplat
from audio_motion_avatar_tpu.ops import splat_pallas as jsp
from audio_motion_avatar_tpu.ops.cameras import make_camera as jmake_camera

from audio_motion_avatar_tpu_torch.ops import splat as tsplat
from audio_motion_avatar_tpu_torch.ops import splat_segmented as tss
from audio_motion_avatar_tpu_torch.ops.cameras import make_camera as tmake_camera

from splat_segment_cases import edge_segments
from torch_parity import one_torch_thread  # noqa: F401


def gaussians(n, seed, frames=1):
    rng = np.random.RandomState(seed)
    xyz = (rng.randn(frames, n, 3) * 0.4).astype(np.float32)
    rot = rng.randn(frames, n, 4).astype(np.float32)
    rot[..., 0] += 3.0
    s = (rng.randn(frames, n, 3) * 0.3 + 1.0).astype(np.float32) - 3.0
    o = (rng.randn(frames, n) * 2).astype(np.float32)
    c = rng.rand(frames, n, 3).astype(np.float32)
    K = np.tile(np.array([[80.0, 0, 32.0], [0, 80.0, 32.0], [0, 0, 1.0]],
                         np.float32), (frames, 1, 1))
    E = np.tile(np.eye(4, dtype=np.float32), (frames, 1, 1))
    E[:, 2, 3] = 2.0 + 0.2 * np.arange(frames)
    return xyz, rot, s, o, c, K, E


def jax_proj(g, f, w=64, h=64):
    xyz, rot, s, o, c, K, E = g
    cam = jmake_camera(jnp.asarray(K[f]), jnp.asarray(E[f]), w, h)
    return jsplat.project_gaussians(
        jnp.asarray(xyz[f]), jnp.asarray(rot[f]),
        jsplat.activate_scales(jnp.asarray(s[f])),
        jsplat.activate_opacity(jnp.asarray(o[f])), jnp.asarray(c[f]), cam)


def torch_proj_from(jp):
    """The JAX projection's arrays as a one-frame torch Projected."""
    return tsplat.Projected(*(torch.tensor(np.asarray(a))[None] for a in jp))


def test_project_gaussians_matches_jax():
    g = gaussians(300, 0, frames=2)
    xyz, rot, s, o, c, K, E = g
    cam = tmake_camera(torch.as_tensor(K), torch.as_tensor(E), 64, 64)
    tp = tsplat.project_gaussians(
        torch.as_tensor(xyz), torch.as_tensor(rot),
        tsplat.activate_scales(torch.as_tensor(s)),
        tsplat.activate_opacity(torch.as_tensor(o)), torch.as_tensor(c), cam)
    for f in range(2):
        jp = jax_proj(g, f)
        for name in ("mean2d", "conic", "depth", "opacity"):
            np.testing.assert_allclose(getattr(tp, name)[f].numpy(),
                                       np.asarray(getattr(jp, name)),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
        np.testing.assert_array_equal(tp.valid[f].numpy(), np.asarray(jp.valid))
        np.testing.assert_array_equal(tp.radius[f].numpy(), np.asarray(jp.radius))


@pytest.mark.parametrize("large_cap,kcap", [(0, 64), (128, 64), (2, 200)])
def test_pack_sorted_params_matches_jax(large_cap, kcap):
    """Same starts, counts and per-tile segments as _pack_sorted_params
    (single tier; two tier with a generous cap; two tier overflowing)."""
    jp = jax_proj(gaussians(200, 3), 0)
    pj, sj, cj = jsp._pack_sorted_params(jp, 64, 64, kcap, max_window=4,
                                         large_cap=large_cap)
    pt, st, ct = tss.pack_sorted_params(torch_proj_from(jp), 64, 64, kcap, 4,
                                        large_cap=large_cap)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    pj, pt = np.asarray(pj), pt.numpy()
    for t, (s0, n) in enumerate(zip(st.numpy(), ct.numpy())):
        np.testing.assert_array_equal(pt[:, s0:s0 + n], pj[:9, s0:s0 + n],
                                      err_msg=f"tile {t}")


def test_top_k_breaks_ties_toward_lower_index():
    rng = np.random.RandomState(0)
    score = rng.randint(0, 4, size=(3, 50)).astype(np.float32)
    _, ji = jax.lax.top_k(jnp.asarray(score), 20)
    ti = tss.top_k_lower_index(torch.as_tensor(score), 20)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_depth_key_is_order_preserving():
    d = torch.tensor([-3.0, -1e-30, -0.0, 0.0, 1e-30, 0.5, 2.0, 1e30])
    k = tss._depth_key(d)
    assert (k[1:] >= k[:-1]).all() and k[2] == k[3]
    assert (k >= 0).all() and (k < 2 ** 32).all()


def test_render_segmented_matches_jax_interpret():
    F, N, W, H = 3, 150, 64, 64
    xyz, rot, s, o, c, K, E = gaussians(N, 1, frames=F)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jsp.render_frames_segmented(
            jnp.asarray(xyz), jnp.asarray(rot), jnp.asarray(s), jnp.asarray(o),
            jnp.asarray(c), jnp.asarray(K), jnp.asarray(E), W, H,
            max_per_tile=64, max_window=4, large_cap=32))
    out = tss.render_frames_segmented(
        *(torch.as_tensor(a) for a in (xyz, rot, s, o, c, K, E)), W, H,
        max_per_tile=64, max_window=4, large_cap=32).numpy()
    assert out.shape == (F, H, W, 3)
    assert (out < 0.99).any(), "frames must not be blank"
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)


def test_render_naive_matches_jax():
    g = gaussians(120, 2)
    jp = jax_proj(g, 0)
    ref = np.asarray(jsplat.render_naive(jp, 64, 64))
    tp = tsplat.Projected(*(torch.tensor(np.asarray(a)) for a in jp))
    np.testing.assert_allclose(tsplat.render_naive(tp, 64, 64).numpy(), ref,
                               atol=2e-5, rtol=0)


def test_segmented_matches_naive_when_nothing_overflows():
    """K >= N and a window covering the image: binning drops nothing, so
    the segmented composite equals the unbinned oracle."""
    g = gaussians(100, 4)
    jp = jax_proj(g, 0)
    tp = torch_proj_from(jp)
    params, starts, counts = tss.pack_sorted_params(tp, 64, 64, 512, 4)
    tiles = tss.composite_segments(params, starts, counts, 4, 16)
    img = tss.tiles_to_image(tiles, 4, 4)
    ref = tsplat.render_naive(tsplat.Projected(*(a[0] for a in tp)), 64, 64)
    np.testing.assert_allclose(img.numpy(), ref.numpy(), atol=2e-5, rtol=0)


def test_composite_wrapper_refuses_other_devices():
    p = torch.zeros(9, 4, device="meta")
    s = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tss.composite_segments(p, s, s, 1, 1)
    assert tss.composite_segments.launches == 0


def segment_walk(params, starts, counts, tx, tiles_per_frame):
    """Kernel S's walk (csrc/splat_walk.cuh) in plain torch, one segment
    position per step: a far pair (power < -5.6, opacity <= 1) and a pair the
    alpha rule drops are skipped (log T, T and the colour stay as they are),
    T = exp(log T) is carried from kept slot to kept slot, and a tile stops
    at the end of its segment."""
    n = starts.shape[0]
    px, py = tsplat.tile_pixels(n, tx, tiles_per_frame, params.device)
    logT = torch.zeros(n, tss.P)
    T = torch.ones(n, tss.P)
    acc = torch.zeros(3, n, tss.P)
    for j in range(int(counts.max())):
        walked = j < counts.long()
        g = params[:, torch.where(walked, starts.long() + j, 0)]
        _, _, power, _, _, alpha, keep = tsplat.slot_alpha(g, px, py)
        far = (power < -5.6) & (g[5] <= 1.0)[:, None]
        kept = walked[:, None] & ~far & keep
        logT_after = logT + torch.log1p(-alpha)
        T_after = torch.exp(logT_after)
        w = alpha * T
        add = kept & ~(T_after < tsplat.T_EPS)
        acc = torch.where(add[None], acc + w[None] * g[6:9][:, :, None], acc)
        logT = torch.where(kept, logT_after, logT)
        T = torch.where(kept, T_after, T)
    return torch.clamp(acc + T[None], 0.0, 1.0).permute(1, 2, 0).contiguous()


@pytest.mark.parametrize("inputs", ["projected", "edges"])
def test_segment_walk_is_the_plain_blend_bit_for_bit(inputs):
    """Kernel S's bit-identity rests on its cuts being identities: skipping
    a far or dropped pair and carrying T change no bit of the plain
    version's sequential blend. Two frames binned with K = 24 (clamped and empty
    segments), and the hand-made edges (chunk lengths 128 and 129, a tile
    whose every pair drops, one whose pixels fall under T 1e-4 early)."""
    if inputs == "projected":
        F, N, W, H, K = 2, 150, 96, 64, 24
        xyz, rot, s, o, c, Kc, E = gaussians(N, 5, frames=F)
        cam = tmake_camera(torch.as_tensor(Kc), torch.as_tensor(E), W, H)
        proj = tsplat.project_gaussians(
            torch.as_tensor(xyz), torch.as_tensor(rot),
            tsplat.activate_scales(torch.as_tensor(s)),
            tsplat.activate_opacity(torch.as_tensor(o)), torch.as_tensor(c), cam)
        params, starts, counts = tss.pack_sorted_params(proj, W, H, K, 4, large_cap=32)
        args = (params, starts, counts, W // 16, (W // 16) * (H // 16))
        assert bool((counts == 0).any()) and bool((counts == K).any())
    else:
        args = edge_segments("cpu")
    want = tss.composite_segments_plain(*args)
    got = segment_walk(*args)
    assert torch.equal(got, want)
    assert bool((want < 0.999).any())
    if inputs == "edges":
        assert bool((want[0] == 1.0).all()) and bool((want[5] == 1.0).all())
        assert float(want[6].max()) < 1.0
