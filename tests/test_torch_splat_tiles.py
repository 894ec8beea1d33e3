"""Port's tile splat (ops/splat_tiles.py, splat.bin_gaussians_sorted) vs the
JAX one.

The composite is kernel K1's plain version (the wrapper takes it for CPU
tensors). The JAX side runs its Pallas tile composite in interpret mode,
as tests/test_splat_pallas.py does, and its XLA twin. Tolerances: binning
and packing exact (same sort keys, stable sorts, same gathers); composite
1e-5 absolute (sequential vs prefix-sum transmittance, fp32); images
through the whole render 2e-5 absolute.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from audio_motion_avatar_tpu.ops import splat as jsplat
from audio_motion_avatar_tpu.ops import splat_pallas as jsp

from audio_motion_avatar_tpu_torch.ops import splat as tsplat
from audio_motion_avatar_tpu_torch.ops import splat_tiles as tst
from test_torch_splat import gaussians, jax_proj, torch_proj_from
from torch_parity import one_torch_thread  # noqa: F401

W = H = 64
TX = W // 16


def _packed(n, seed, frames, K, window):
    g = gaussians(n, seed, frames=frames)
    jps = [jax_proj(g, f) for f in range(frames)]
    ref = np.stack([np.asarray(jsp._pack_tile_params(p, W, H, K, window)) for p in jps])
    got = torch.stack([tst.pack_tile_params(
        tsplat.Projected(*(a[0] for a in torch_proj_from(p))), W, H, K, window)
        for p in jps])
    return g, ref, got


@pytest.mark.parametrize("n,K,window", [(300, 64, 4), (300, 16, 8), (40, 512, 8)])
def test_bin_gaussians_sorted_matches_jax(n, K, window):
    """Clamped tiles (K=16 < overlaps), truncated windows and K > N."""
    jp = jax_proj(gaussians(n, 1), 0)
    ref = jsplat.bin_gaussians_sorted(jp, W, H, K, max_window=window)
    got = tsplat.bin_gaussians_sorted(
        tsplat.Projected(*(a[0] for a in torch_proj_from(jp))), W, H, K,
        max_window=window)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert bool(got[2].any()) and not bool(got[2].all())


@pytest.mark.parametrize("K,window", [(64, 4), (16, 8)])
def test_pack_tile_params_exact(K, window):
    _, ref, got = _packed(300, 2, 1, K, window)
    assert got.shape == ref.shape == (1, TX * TX, 9, min(K, 300))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("frames", [1, 3])
def test_composite_plain_matches_pallas_interpret(frames):
    """frames = 3: one grid over three stacked views, tile origins from
    tile % tiles_per_frame as the TPU kernel's ntpf scalar."""
    _, ref_packed, got_packed = _packed(300, 3, frames, 64, 4)
    T = TX * TX
    stacked = ref_packed.reshape(frames * T, 9, -1)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jsp._composite_tiles_pallas(jnp.asarray(stacked), TX, T))
    got = tst.composite_tiles(got_packed.reshape(frames * T, 9, -1), TX, T)
    assert got.shape == (frames * T, 256, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    assert (ref < 0.999).any() and (ref > 0.999).any()


def test_composite_plain_matches_xla_twin():
    _, ref_packed, got_packed = _packed(300, 4, 1, 64, 8)
    ref = np.asarray(jsp._composite_tiles_xla(jnp.asarray(ref_packed[0]),
                                              jsp._tile_origins(TX, TX)))
    got = tst.composite_tiles_plain(got_packed[0], TX)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_render_frames_matches_render_frames_pallas():
    """The whole default splat of F frames (projection, per-frame binning,
    one composite over all frames' tiles) against render_frames_pallas in
    interpret mode."""
    xyz, rot, s, o, c, K, E = gaussians(300, 5, frames=2)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jsp.render_frames_pallas(
            *(jnp.asarray(a) for a in (xyz, rot, s, o, c, K, E)), W, H,
            max_per_tile=64, max_window=4, batched_binning=False))
    got = tst.render_frames(*(torch.as_tensor(a) for a in (xyz, rot, s, o, c, K, E)),
                            W, H, max_per_tile=64, max_window=4)
    assert got.shape == (2, H, W, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)


def test_render_multi_view_matches_jax():
    """One gaussian set per batch entry from T cameras: the JAX package's
    render_multi_view (XLA tiles, vmapped views) vs the port's single
    composite launch over all B*T views."""
    xyz, rot, s, o, c, K, E = gaussians(300, 6, frames=2)     # 2 batch entries
    Kt = np.stack([K, K * np.array([[1.1, 1, 1], [1, 1.1, 1], [1, 1, 1]], np.float32)], 1)
    Et = np.stack([E, E], 1)
    Et[:, 1, 0, 3] = 0.2
    g = {"xyz": xyz, "rot": rot, "scale": s, "opacity": o, "color": c}
    ref = np.asarray(jsplat.render_multi_view({k: jnp.asarray(v) for k, v in g.items()},
                                              jnp.asarray(Kt), jnp.asarray(Et), W, H,
                                              max_per_tile=64))
    got = tst.render_multi_view({k: torch.as_tensor(v) for k, v in g.items()},
                                torch.as_tensor(Kt), torch.as_tensor(Et), W, H,
                                max_per_tile=64)
    assert got.shape == (2, 2, H, W, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)


def test_composite_tiles_counts_launches_only_on_the_card():
    """On a CPU tensor the wrapper runs the plain version and counts
    nothing; the count is the kernel's launches."""
    before = tst.composite_tiles.launches
    tst.composite_tiles(torch.zeros(2, 9, 4), 2)
    assert tst.composite_tiles.launches == before
    with pytest.raises(ValueError):
        tst.composite_tiles(torch.zeros(2, 9, 4, device="meta"), 2)
