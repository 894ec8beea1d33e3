"""Port's triplane ops (ops/triplane.py, tile selection) vs the JAX ones.

Quad rows are kernel Q's plain version and must equal the JAX quad_rows
bit for bit; neighbour slots, tile selection and slot ranks are integer
results compared exactly; the bilinear quad sampler is fp32 to 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_motion_avatar_tpu.models import upsampler as jup
from audio_motion_avatar_tpu.ops import triplane as jtp

from audio_motion_avatar_tpu_torch.models import upsampler as tup
from audio_motion_avatar_tpu_torch.ops import triplane as ttp
from torch_parity import one_torch_thread  # noqa: F401


def selection(FP=4, n=400, grid=8, cap=20, tile_px=16, seed=0):
    """Body-like uv clouds -> JAX select_tiles results per plane."""
    rng = np.random.RandomState(seed)
    uv = (rng.randn(FP, n, 2) * np.array([0.25, 0.5])).astype(np.float32)
    outs = [jup.select_tiles(jnp.asarray(u), grid, cap, tile_px) for u in uv]
    return uv, [np.stack([np.asarray(o[i]) for o in outs]) for i in range(4)]


@pytest.mark.parametrize("cap", [20, 64])
def test_select_tiles_matches_jax(cap):
    """Includes cap below the covered count, where ties in the dilated
    count decide which tiles drop (toward the lower id, as lax.top_k)."""
    uv, (ids, valid, slot, sorted_ids) = selection(cap=cap)
    t_ids, t_valid, t_slot, t_sorted = tup.select_tiles(torch.as_tensor(uv), 8, cap, 16)
    np.testing.assert_array_equal(t_ids.numpy(), ids)
    np.testing.assert_array_equal(t_valid.numpy(), valid)
    np.testing.assert_array_equal(t_slot.numpy(), slot)
    np.testing.assert_array_equal(t_sorted.numpy(), sorted_ids)


def test_neighbor_slots_match_jax():
    _, (_, _, slot, _) = selection(cap=20)
    ref = [np.stack(x) for x in zip(*[jtp._neighbor_slots(jnp.asarray(s), 8, 20)
                                      for s in slot])]
    got = ttp.neighbor_slots(torch.as_tensor(slot), 8, 20)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), r)


@pytest.mark.parametrize("cap", [20, 64])
def test_quad_rows_bit_exact(cap):
    uv, (_, _, slot, _) = selection(cap=cap)
    rng = np.random.RandomState(1)
    tiles = rng.randn(4, cap, 16, 16, 8).astype(np.float32)
    ref = np.asarray(jax.vmap(lambda t, s: jtp.quad_rows(t, s, 8))(
        jnp.asarray(tiles), jnp.asarray(slot)))
    got = ttp.quad_rows(torch.as_tensor(tiles), torch.as_tensor(slot), 8).numpy()
    assert got.shape == (4, cap, 16, 16, 32)
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_sample_triplane_sparse_quad_matches_jax():
    B, cap, T, C, grid = 2, 20, 16, 8, 8
    rng = np.random.RandomState(2)
    pts = (rng.randn(B, 300, 3) * np.array([0.3, 0.6, 0.2])).astype(np.float32)
    u = np.clip(pts / 1.4, -1, 1)
    uv = np.stack([np.stack([u[..., a], u[..., b]], -1) for a, b in jtp.PLANE_AXES], 1)
    sel = [jup.select_tiles(jnp.asarray(x), grid, cap, T) for x in uv.reshape(-1, 300, 2)]
    ids, valid, slot, sorted_ids = (np.stack([np.asarray(s[i]) for s in sel])
                                    .reshape((B, 3) + np.asarray(sel[0][i]).shape)
                                    for i in range(4))
    tiles = rng.randn(B, 3, cap, T, T, C).astype(np.float32)
    jsp = jup.SparseTriplanes(jnp.asarray(tiles), jnp.asarray(slot), jnp.asarray(valid),
                              grid, T, grid * T, jnp.asarray(sorted_ids))
    jq = jtp.build_quad(jsp.tiles, jsp.slot, grid)
    ref = np.asarray(jtp.sample_triplane_sparse_quad(jsp, jq, jnp.asarray(pts), 1.4))
    tsp = tup.SparseTriplanes(torch.as_tensor(tiles), torch.as_tensor(slot),
                              torch.as_tensor(valid), grid, T, grid * T,
                              torch.as_tensor(sorted_ids))
    tq = ttp.build_quad(tsp.tiles, tsp.slot, grid)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    got = ttp.sample_triplane_sparse_quad(tsp, tq, torch.as_tensor(pts), 1.4)
    assert got.shape == (B, 300, 3 * C)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


def test_slot_rank_matches_jax():
    _, (_, _, _, sorted_ids) = selection(cap=20)
    tid = np.random.RandomState(3).randint(0, 64, size=(4, 50))
    for f in range(4):
        rs, rp = jtp.slot_rank(jnp.asarray(sorted_ids[f]), jnp.asarray(tid[f]))
        ts, tpres = ttp.slot_rank(torch.as_tensor(sorted_ids[f:f + 1]).long(),
                                  torch.as_tensor(tid[f:f + 1]).long())
        np.testing.assert_array_equal(tpres[0].numpy(), np.asarray(rp))
        np.testing.assert_array_equal(ts[0].numpy()[np.asarray(rp)],
                                      np.asarray(rs)[np.asarray(rp)])


def test_tokens_to_planes_matches_jax():
    x = np.random.RandomState(4).randn(2, 5, 3 * 16).astype(np.float32)
    np.testing.assert_array_equal(ttp.tokens_to_planes(torch.as_tensor(x), 4).numpy(),
                                  np.asarray(jtp.tokens_to_planes(jnp.asarray(x), 4)))


def test_quad_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        ttp.quad_rows(torch.zeros(1, 2, 4, 4, 8, device="meta"),
                      torch.zeros(1, 4, dtype=torch.long, device="meta"), 2)
    assert ttp.quad_rows.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_scatter_mean_is_the_jax_segment_mean_bit_for_bit(dtype):
    """The segment mean sums each cell in point order, as the JAX package's
    segment_sum does on the CPU: the same bits in float32, bfloat16 and
    float16, where a cell of more than 256 points saturates the bfloat16
    count in both."""
    rng = np.random.RandomState(5)
    B, N, C, R = 2, 3000, 8, 8
    v = rng.randn(B, N, C).astype(np.float32)
    idx = rng.randint(0, R * R, (B, N))
    idx[:, :600] = 3                 # one crowded cell
    idx[:, 600:700] = R * R - 1
    want = jtp.scatter_mean_plane(jnp.asarray(v, dtype), jnp.asarray(idx, jnp.int32), R)
    got = ttp.scatter_mean_plane(torch.as_tensor(v).to(getattr(torch, dtype)),
                                 torch.as_tensor(idx, dtype=torch.long), R)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
