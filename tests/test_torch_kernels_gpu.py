"""The port's CUDA kernels against their plain PyTorch versions, on
the card, at small and ragged shapes (chip_smoke.py holds them at the
main paths' shapes). Every test needs a CUDA card and nvcc, and skips without
one. This file imports no JAX, so on a machine without it run it without
the JAX test harness's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py -q

Tolerances: S and K1 1e-5 absolute (the kernels are built with
--fmad=false and blend in the plain versions' order); Q bit-exact (a copy)
and Q-bwd bit-exact (the same fp32 adds in the same order); A's bf16
outputs against the plain version in fp32 on the same bf16 inputs: every
|diff| <= 2^-7 |ref| + 2^-4 RMS(ref) (ops/attention.excess_error), and
A-bwd's bf16 dQ / dK / dV against the fp32 plain backward under the same
rule; K2 against its plain version at rtol 1e-4 (the JAX package's own
tolerance for its backward kernel) and atol 1e-5 of the largest |ref| (the
per-slot sums over a tile's 256 pixels are added in another order); K9a and
K9b (Winograd) against their plain versions on the same bf16 inputs under
ops/winograd.excess_error (every |diff| <= 2^-7 |ref| + 2^-8 RMS(ref), the
mean within 1e-2 of the Winograd-vs-direct distance). SFC (the curve
codes) bit-exact: integers after one fp32 multiply. SC (the sparse conv)
against its plain version's float64 sums on the same bf16 inputs under
ops/sparse_conv.excess_error (every |diff| <= 2^-7 |ref| + 2^-12 RMS(ref):
one bf16 spacing, of which the output's rounding costs at most half, and
fp32 sums in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

from audio_motion_avatar_tpu_torch.ops import attention as at
from audio_motion_avatar_tpu_torch.ops import serialization as ser
from audio_motion_avatar_tpu_torch.ops import sparse_conv as sc
from audio_motion_avatar_tpu_torch.ops import splat_segmented as ss
from audio_motion_avatar_tpu_torch.ops import splat_tiles as st
from audio_motion_avatar_tpu_torch.ops import triplane as tp
from audio_motion_avatar_tpu_torch.ops import winograd as wg
from audio_motion_avatar_tpu_torch.ops.cameras import make_camera
from audio_motion_avatar_tpu_torch.ops.splat import (activate_opacity,
                                                     activate_scales,
                                                     project_gaussians)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("inputs", ["one-tier K512", "two-tier K24", "edges"])
def test_splat_kernel_matches_plain(cuda, inputs):
    """2 frames at 128x96, 400 gaussians: empty, short and (K=24) clamped
    segments, one- and two-tier binning; and the hand-made edges of
    tests/splat_segment_cases.py: segments of exactly 128 entries, of 129,
    300 and 512, a tile whose every pair is dropped (white), one whose pixels
    fall under T 1e-4 before its segment ends, unaligned starts. Held against
    the plain version at 1e-5, and a second launch bit for bit."""
    if inputs == "edges":
        from splat_segment_cases import edge_segments
        params, starts, counts, tx, tpf = edge_segments(cuda)
    else:
        large_cap, K = (0, 512) if inputs == "one-tier K512" else (16, 24)
        F, N, W, H = 2, 400, 128, 96
        rng = np.random.RandomState(0)

        def r(*shape, s=1.0):
            return torch.as_tensor((rng.randn(*shape) * s).astype(np.float32), device=cuda)

        Km = torch.tensor([[70.0, 0, W / 2], [0, 70.0, H / 2], [0, 0, 1]], device=cuda)
        E = torch.eye(4, device=cuda).repeat(F, 1, 1)
        E[:, 2, 3] = torch.tensor([2.0, 2.5], device=cuda)
        proj = project_gaussians(r(F, N, 3, s=0.4), r(F, N, 4),
                                 activate_scales(r(F, N, 3, s=0.3) - 2),
                                 activate_opacity(r(F, N, s=2.0)),
                                 torch.rand(F, N, 3, device=cuda),
                                 make_camera(Km.expand(F, 3, 3), E, W, H))
        params, starts, counts = ss.pack_sorted_params(proj, W, H, K, 4, large_cap=large_cap)
        tx, tpf = W // 16, (W // 16) * (H // 16)
        assert bool((counts == 0).any()) and 0 < int(counts.max()) <= K
    before = ss.composite_segments.launches
    got = ss.composite_segments(params, starts, counts, tx, tpf)
    again = ss.composite_segments(params, starts, counts, tx, tpf)
    want = ss.composite_segments_plain(params, starts, counts, tx, tpf)
    torch.cuda.synchronize()
    assert ss.composite_segments.launches == before + 2
    assert float((got - want).abs().max()) <= 1e-5
    assert torch.equal(got, again)
    if inputs == "edges":
        assert bool((got[0] == 1.0).all()) and bool((got[5] == 1.0).all())
        assert float(got[6].max()) < 1.0 and bool((got[1:5] < 0.999).any())


@pytest.mark.parametrize("K,window", [(512, 4), (24, 8), (200, 4)])
def test_tile_kernel_matches_plain(cuda, K, window):
    """3 views at 128x96 in one launch (tile origins from tile % tiles per
    frame), 400 gaussians: empty and clamped tiles, K above and below the
    128-slot chunk."""
    F, N, W, H = 3, 400, 128, 96
    rng = np.random.RandomState(1)

    def r(*shape, s=1.0):
        return torch.as_tensor((rng.randn(*shape) * s).astype(np.float32), device=cuda)

    Km = torch.tensor([[70.0, 0, W / 2], [0, 70.0, H / 2], [0, 0, 1]], device=cuda)
    E = torch.eye(4, device=cuda).repeat(F, 1, 1)
    E[:, 2, 3] = torch.tensor([2.0, 2.5, 3.0], device=cuda)
    gs = [r(F, N, 3, s=0.4), r(F, N, 4), r(F, N, 3, s=0.3) - 2, r(F, N, s=2.0),
          torch.rand(F, N, 3, device=cuda)]
    from audio_motion_avatar_tpu_torch.ops.cameras import make_camera
    proj = project_gaussians(gs[0], gs[1], activate_scales(gs[2]), activate_opacity(gs[3]),
                             gs[4], make_camera(Km.expand(F, 3, 3), E, W, H))
    packed = torch.cat([st.pack_tile_params(
        type(proj)(*(a[f] for a in proj)), W, H, K, window) for f in range(F)])
    tx, T = W // 16, (W // 16) * (H // 16)
    before = st.composite_tiles.launches
    got = st.composite_tiles(packed, tx, T)
    want = st.composite_tiles_plain(packed, tx, T)
    torch.cuda.synchronize()
    assert st.composite_tiles.launches == before + 1
    assert got.shape == (F * T, 256, 3)
    assert float((got - want).abs().max()) <= 1e-5
    assert bool((want < 0.999).any()) and bool((want > 0.999).any())


def test_tile_wrapper_validates(cuda):
    with pytest.raises(ValueError, match="float32"):
        st.composite_tiles(torch.zeros(2, 9, 4, dtype=torch.float16, device=cuda), 2)
    with pytest.raises(ValueError, match="contiguous"):
        st.composite_tiles(torch.zeros(2, 4, 9, device=cuda).transpose(1, 2), 2)


@pytest.mark.parametrize("dtype,C", [(torch.bfloat16, 24), (torch.float32, 4)])
def test_quad_kernel_bit_exact(cuda, dtype, C):
    """Holes in the slot table (missing neighbours read 0), a 16-byte texel
    and a three-vector texel."""
    FP, grid, T, cap = 3, 4, 4, 9
    g = torch.Generator(device=cuda).manual_seed(0)
    slot = torch.full((FP, grid * grid), -1, dtype=torch.long, device=cuda)
    for f in range(FP):
        ids = torch.randperm(grid * grid, generator=g, device=cuda)[:cap - f].sort().values
        slot[f, ids] = torch.arange(ids.numel(), device=cuda)
    tiles = torch.randn(FP, cap, T, T, C, generator=g, device=cuda).to(dtype)
    got = tp.quad_rows(tiles, slot, grid)
    want = tp.quad_rows_plain(tiles, slot, grid)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _quad_slots(cuda, FP, grid, cap, covered, g):
    """(FP, G*G) slot maps of `covered[f]` random tiles each (tile 0 and its
    right / bottom / diagonal neighbours among them, so that the cap -
    covered unused slots alias onto them), slots in tile order."""
    slot = torch.full((FP, grid * grid), -1, dtype=torch.long, device=cuda)
    for f in range(FP):
        rest = torch.randperm(grid * grid - 4, generator=g, device=cuda) + 4
        fixed = torch.tensor([0, 1, grid, grid + 1], device=cuda)
        ids = torch.cat([fixed, rest[:covered[f] - 4]]).sort().values
        slot[f, ids] = torch.arange(ids.numel(), device=cuda)
    return slot


@pytest.mark.parametrize("dtype,C,T,grid,cap,covered,unused_zero", [
    (torch.bfloat16, 24, 4, 4, 12, [12, 10, 5], False),
    (torch.bfloat16, 256, 3, 4, 12, [12, 10, 5], False),
    (torch.float32, 4, 4, 4, 12, [12, 10, 5], False),
    (torch.float32, 12, 1, 4, 12, [12, 10, 5], False),
    (torch.bfloat16, 24, 2, 4, 12, [12, 10, 5], False),
    (torch.bfloat16, 16, 4, 8, 40, [5, 13, 40], False),
    (torch.bfloat16, 16, 4, 8, 40, [5, 13, 40], True),
    (torch.float32, 8, 3, 8, 40, [5, 13, 40], True),
    (torch.bfloat16, 256, 16, 8, 40, [5, 13, 40], False),
    (torch.float32, 256, 16, 8, 40, [5, 13, 40], True),
])
def test_quad_bwd_kernel_bit_exact(cuda, dtype, C, T, grid, cap, covered, unused_zero):
    """Q-bwd against its plain version bit for bit, and a second launch:
    full, partial and under-filled slot maps (unused slots aliasing tile 0's
    neighbours), texels of one, two, three and 32 vectors, tiles of one and
    two texels a side; heavily aliased maps (5 or 13 of 40 slots covered:
    runs of 36 and 29 sources, past the kernel's unroll of 8 and not
    multiples of it; also at 16^2-texel tiles of 256 channels, whose edge
    vectors outnumber the block's threads), also with the unused slots'
    cotangent rows all -0.0, as the sampler's masked points leave them
    (sums of -0.0 from +0: the sign of every zero must match)."""
    FP = len(covered)
    g = torch.Generator(device=cuda).manual_seed(2)
    slot = _quad_slots(cuda, FP, grid, cap, covered, g)
    dquad = torch.randn(FP, cap, T, T, 4 * C, generator=g, device=cuda).to(dtype)
    if unused_zero:
        for f, n in enumerate(covered):
            dquad[f, n:] = -0.0
    got = tp.quad_rows_bwd(dquad, slot, grid)
    again = tp.quad_rows_bwd(dquad, slot, grid)
    want = tp.quad_rows_bwd_plain(dquad, slot, grid)
    cpu = tp.quad_rows_bwd_plain(dquad.cpu(), slot.cpu(), grid)
    torch.cuda.synchronize()
    ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(ints), want.view(ints))
    assert torch.equal(got.view(ints), again.view(ints))
    assert torch.equal(cpu.view(ints), want.cpu().view(ints))


def test_quad_rows_function_on_the_card(cuda):
    """build_quad under autograd: Q forward, Q-bwd backward; the tiles'
    gradient equals Q-bwd of the quad rows' gradient, and the launch
    counters rise by one each."""
    FP, grid, cap, T, C = 3, 4, 9, 4, 32
    g = torch.Generator(device=cuda).manual_seed(3)
    slot = _quad_slots(cuda, FP, grid, cap, [9, 7, 6], g).reshape(1, FP, -1)
    tiles = torch.randn(1, FP, cap, T, T, C, generator=g, device=cuda).to(torch.bfloat16)
    tiles.requires_grad_(True)
    n_f, n_b = tp.quad_rows.launches, tp.quad_rows_bwd.launches
    q = tp.build_quad(tiles, slot, grid)
    dq = torch.randn(q.shape, generator=g, device=cuda).to(q.dtype)
    q.backward(dq)
    torch.cuda.synchronize()
    assert (tp.quad_rows.launches - n_f, tp.quad_rows_bwd.launches - n_b) == (1, 1)
    want = tp.quad_rows_bwd_plain(dq[0], slot[0], grid)
    assert torch.equal(tiles.grad[0].view(torch.int16), want.view(torch.int16))


def test_quad_bwd_wrapper_validates(cuda):
    slot = torch.zeros(1, 4, dtype=torch.long, device=cuda)
    with pytest.raises(ValueError, match="16 bytes"):
        tp.quad_rows_bwd(torch.zeros(1, 1, 2, 2, 4 * 4, device=cuda, dtype=torch.bfloat16),
                         slot, 2)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tp.quad_rows_bwd(torch.zeros(1, 1, 2, 2, 4 * 8, device=cuda, dtype=torch.float16),
                         slot, 2)
    with pytest.raises(ValueError, match="slot"):
        tp.quad_rows_bwd(torch.zeros(1, 1, 2, 2, 4 * 8, device=cuda, dtype=torch.bfloat16),
                         slot[:, :3], 2)


@pytest.mark.parametrize("B,H,Sq,Skv,masked", [
    (1, 2, 9, 13, False),      # ragged: fewer queries and keys than a block
    (2, 1, 130, 77, True),     # ragged edges, masks, one batch all masked
    (1, 2, 64, 640, True),     # several key blocks
    (1, 2, 1, 1, False),       # one query, one key
    (2, 2, 63, 65, True),      # one row short of a warpgroup, one key past a tile
    (1, 3, 65, 63, False),     # one row past a warpgroup, one key short of a tile
    (2, 1, 127, 129, True),    # around the 128-query block and the 128-key edge
    (1, 2, 129, 127, False),
    (1, 2, 1, 6304, False),    # one query over the audio length
    (1, 1, 6304, 1, False),    # the audio length over one key
    (1, 1, 6304, 6304, False), # the audio self-attention of one head
    (1, 2, 3152, 6304, True),  # q_tail: Sq != Skv, masked
])
def test_attention_kernel_matches_plain(cuda, B, H, Sq, Skv, masked):
    g = torch.Generator(device=cuda).manual_seed(0)

    def rnd(s):
        return torch.randn(B, H, s, 64, generator=g, device=cuda).to(torch.bfloat16)

    q, k, v = rnd(Sq), rnd(Skv), rnd(Skv)
    mask = None
    if masked:
        lengths = torch.tensor([Skv // 3] + [0] * (B - 1), device=cuda)
        mask = torch.arange(Skv, device=cuda)[None, :] < lengths[:, None]
    got = at.attention(q, k, v, 0.125, mask)
    want = at.attention_plain(q.float(), k.float(), v.float(), 0.125, mask)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, Sq, 64)
    assert at.excess_error(got, want) <= 1.0


def _attention_inputs(cuda, B, H, Sq, Skv, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, H, Sq, 64, generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(B, H, Skv, 64, generator=g, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    return q, k, v


def test_attention_kernel_stats(cuda):
    """The (m, l) that A writes for A-bwd: m the row maximum of the base-2
    logits (q k^T * scale * log2 e, a masked key -1e30), l the sum of
    exp2(logit - m); a row whose keys are all masked has m = -1e30 exactly
    and l = Skv (in fp32 -1e30 + log2 l would round back to -1e30, so the
    two are kept apart). Writing them changes nothing in the output."""
    B, H, Sq, Skv = 3, 2, 100, 150
    q, k, v = _attention_inputs(cuda, B, H, Sq, Skv, 3)
    mask = torch.arange(Skv, device=cuda)[None, :] < torch.tensor([150, 70, 0], device=cuda)[:, None]
    out, stats = at._attention_kernel(q, k, v, 0.125, mask, True)
    torch.cuda.synchronize()
    assert torch.equal(out, at.attention(q, k, v, 0.125, mask))
    x = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * (0.125 * 1.4426950408889634)
    x = x.masked_fill(~mask[:, None, None, :], at.MASKED)
    m = x.amax(-1)
    l = torch.exp2(x - m[..., None]).sum(-1)
    assert torch.allclose(stats[..., 0], m, rtol=1e-5, atol=1e-4)
    assert torch.allclose(stats[..., 1], l, rtol=1e-4)
    assert bool((stats[2, ..., 0] == at.MASKED).all()) and bool((stats[2, ..., 1] == Skv).all())


def test_attention_kernel_block_shapes_agree(cuda):
    """Blocks of 2 and of 3 consumer warpgroups (the launch picks one by the
    waves they fill) compute every row alike: bit-identical outputs and
    statistics, ragged and masked; two launches of either agree bit for bit."""
    from audio_motion_avatar_tpu_torch import kernels

    B, H, Sq, Skv = 2, 3, 250, 333
    q, k, v = _attention_inputs(cuda, B, H, Sq, Skv, 4)
    mask = torch.arange(Skv, device=cuda)[None, :] < torch.tensor([333, 100], device=cuda)[:, None]
    lib = kernels.library("attention")
    results = []
    for nwg in (2, 3, 3, 2):
        out = torch.empty_like(q)
        stats = torch.empty(B, H, Sq, 2, device=cuda)
        kernels.check(lib.attention_launch_nwg(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            stats.data_ptr(), B, H, Sq, Skv, 0.125, kernels.stream_ptr(cuda), nwg), "attention")
        results.append((out, stats))
    torch.cuda.synchronize()
    want = at.attention_plain(q.float(), k.float(), v.float(), 0.125, mask)
    assert at.excess_error(results[0][0], want) <= 1.0
    for out, stats in results[1:]:
        assert torch.equal(out, results[0][0]) and torch.equal(stats, results[0][1])
    assert lib.attention_launch_nwg(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                                    results[0][0].data_ptr(), None, B, H, Sq, Skv, 0.125,
                                    kernels.stream_ptr(cuda), 4) != 0


def test_tma_kernels_launch_from_a_fresh_thread(cuda):
    """The kernels that encode TMA tensor maps (A, A-bwd) launched from a
    thread that has made no CUDA call yet, as the autograd engine's device
    thread is when a backward or a checkpointed forward first reaches them:
    the encoding is a driver call, which needs the device's context current
    on the calling thread (sm90.cuh's bind_context)."""
    import threading

    q, k, v = _attention_inputs(cuda, 1, 2, 9, 13, 7)
    want = at.attention(q, k, v, 0.125)
    want_out, want_stats = at._attention_kernel(q, k, v, 0.125, None, True)
    want_grads = at.attention_bwd(q, k, v, 0.125, None, want_out, want_stats, q)
    torch.cuda.synchronize()
    got = {}

    def work():
        try:
            got["out"] = at.attention(q, k, v, 0.125)
            got["grads"] = at.attention_bwd(q, k, v, 0.125, None, want_out, want_stats, q)
            torch.cuda.synchronize()
        except Exception as e:   # handed to the test's thread
            got["error"] = e

    t = threading.Thread(target=work)
    t.start()
    t.join()
    assert "error" not in got, got.get("error")
    assert torch.equal(got["out"], want)
    for a, b in zip(got["grads"], want_grads):
        assert torch.equal(a, b)


def test_attention_wrapper_validates(cuda):
    q = torch.zeros(1, 1, 8, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="D=64"):
        at.attention(q, q, q, 0.125)
    q = torch.zeros(1, 1, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        at.attention(q, q, q, 0.125)


def test_fp32_rollout_with_kernel_heads_raises(cuda):
    """Kernel A takes bf16 operands: an fp32 configuration with 64-wide
    heads is refused on the card, not run in bf16 behind the caller's back."""
    from audio_motion_avatar_tpu_torch.models.config import AvatarConfig, serving_config
    from audio_motion_avatar_tpu_torch.serve import build_rollout

    cfg = serving_config(dataclasses.replace(AvatarConfig.tiny(image_size=(32, 32)),
                                             audio_transformer_head_dim=64))
    with pytest.raises(ValueError, match="bf16"):
        build_rollout(cfg, device=cuda)


def test_fp32_reconstruction_with_kernel_heads_raises(cuda):
    """The same refusal for the stage-1 entry point: 64-wide predictor and
    fusion heads in an fp32 configuration."""
    from audio_motion_avatar_tpu_torch.models.config import AvatarConfig
    from audio_motion_avatar_tpu_torch.ops import smplx as smplx_ops
    from audio_motion_avatar_tpu_torch.reconstruct import build_reconstructor

    cfg = dataclasses.replace(AvatarConfig.tiny(), smplx_transformer_head_dim=64)
    with pytest.raises(ValueError, match="bf16"):
        build_reconstructor(cfg, device=cuda,
                            smplx_model=smplx_ops.synthetic_model(seed=0, num_verts=300))


def _tile_setup(cuda, K, window, F=3, N=400, W=128, H=96, seed=1):
    rng = np.random.RandomState(seed)

    def r(*shape, s=1.0):
        return torch.as_tensor((rng.randn(*shape) * s).astype(np.float32), device=cuda)

    Km = torch.tensor([[70.0, 0, W / 2], [0, 70.0, H / 2], [0, 0, 1]], device=cuda)
    E = torch.eye(4, device=cuda).repeat(F, 1, 1)
    E[:, 2, 3] = torch.tensor([2.0, 2.5, 3.0][:F], device=cuda)
    proj = project_gaussians(r(F, N, 3, s=0.4), r(F, N, 4), activate_scales(r(F, N, 3, s=0.3) - 2),
                             activate_opacity(r(F, N, s=2.0)), torch.rand(F, N, 3, device=cuda),
                             make_camera(Km.expand(F, 3, 3), E, W, H))
    packed = torch.cat([st.pack_tile_params(
        type(proj)(*(a[f] for a in proj)), W, H, K, window) for f in range(F)])
    return packed, W // 16, (W // 16) * (H // 16)


def _bwd_close(got, want):
    return bool(torch.allclose(got, want, rtol=1e-4, atol=1e-5 * float(want.abs().max())))


@pytest.mark.parametrize("K,window", [(512, 4), (24, 8), (200, 4)])
def test_tile_bwd_kernel_matches_plain(cuda, K, window):
    """K2 on 3 views in one launch: empty and clamped tiles, K above and
    below the 32-slot chunk, a seeded output gradient."""
    packed, tx, T = _tile_setup(cuda, K, window)
    g = torch.randn(packed.shape[0], 256, 3, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(2))
    before = st.composite_tiles_bwd.launches
    got = st.composite_tiles_bwd(packed, g, tx, T)
    want = st.composite_tiles_bwd_plain(packed, g, tx, T)
    torch.cuda.synchronize()
    assert st.composite_tiles_bwd.launches == before + 1
    assert got.shape == packed.shape and torch.isfinite(got).all()
    assert float(want.abs().max()) > 0
    assert _bwd_close(got, want), float((got - want).abs().max())


def _live_prefix_tiles(cuda, K, seed=5):
    """Packed params (6, 9, K) of tiles 0..5 of a 48x32 frame (tx = 3) made
    to reach K2's edges: tile 0 has no live slot, tile 1 all K, tile 2 a live
    prefix of 20 with opacity-0 slots at 0, 5, 6 and 19 inside it, tile 3
    one live slot at the end (slot K - 1), tile 4 a prefix of K - 1, tile 5
    every other slot live. Means scatter around each tile (some off it),
    conics from broad to point-like (most pixels drop those); tile 3's one
    slot is broad and on the tile."""
    rng = np.random.RandomState(seed)
    T, tx = 6, 3
    p = np.zeros((T, 9, K), np.float32)
    for t in range(T):
        ox, oy = (t % tx) * 16, (t // tx) * 16
        p[t, 0] = ox + rng.uniform(-6, 22, K)
        p[t, 1] = oy + rng.uniform(-6, 22, K)
        scale = np.exp(rng.uniform(np.log(0.01), np.log(3.0), K))
        p[t, 2] = scale * rng.uniform(0.5, 1.5, K)
        p[t, 4] = scale * rng.uniform(0.5, 1.5, K)
        p[t, 3] = 0.3 * np.sqrt(p[t, 2] * p[t, 4]) * rng.uniform(-1, 1, K)
        p[t, 5] = rng.uniform(0.05, 0.99, K)
        p[t, 6:9] = rng.uniform(0, 1, (3, K))
    p[0, 5] = 0.0
    p[2, 5, 20:] = 0.0
    p[2, 5, [0, 5, 6, 19]] = 0.0
    p[3, 5, :K - 1] = 0.0
    p[4, 5, K - 1] = 0.0
    p[5, 5, 1::2] = 0.0
    p[3, :6, K - 1] = [8.0, 24.0, 0.02, 0.0, 0.02, 0.8]   # broad, on tile 3's centre
    return torch.as_tensor(p, device=cuda), tx, T


@pytest.mark.parametrize("K", [45, 64, 70])
def test_tile_bwd_kernel_live_prefix(cuda, K):
    """K2 walks each tile's slots up to its last one of nonzero opacity and
    writes 0 past it: tiles with no live slot, all K live, opacity-0 slots
    inside the live prefix, one live slot at the very end; K a multiple of
    the 32-slot chunk and not. Held against the plain version (which walks
    every slot), and two launches agree bit for bit."""
    packed, tx, T = _live_prefix_tiles(cuda, K)
    g = torch.randn(T, 256, 3, device=cuda, generator=torch.Generator(device=cuda).manual_seed(6))
    got = st.composite_tiles_bwd(packed, g, tx, T)
    again = st.composite_tiles_bwd(packed, g, tx, T)
    want = st.composite_tiles_bwd_plain(packed, g, tx, T)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and float(want.abs().max()) > 0
    assert _bwd_close(got, want), float((got - want).abs().max())
    assert torch.equal(got, again)
    assert bool((got[0] == 0).all()) and bool((got[2, :, 20:] == 0).all())
    assert float(got[3, :, K - 1].abs().max()) > 0


@pytest.mark.parametrize("K", [45, 64, 127, 128, 129, 200])
def test_tile_kernel_live_prefix(cuda, K):
    """K1 walks each tile's slots up to its last one of nonzero opacity (the
    first 128-slot chunk staged by the scan itself): a tile with no live slot
    (white), all K live, opacity-0 slots inside the live prefix, one live
    slot at the very end, K below, at and above the 128-slot chunk. Held
    against the plain version (which walks every slot) at 1e-5, and two
    launches agree bit for bit."""
    packed, tx, T = _live_prefix_tiles(cuda, K)
    got = st.composite_tiles(packed, tx, T)
    again = st.composite_tiles(packed, tx, T)
    want = st.composite_tiles_plain(packed, tx, T)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5
    assert torch.equal(got, again)
    assert bool((got[0] == 1.0).all()) and bool((got[3] < 0.999).any())


def test_composite_tiles_function_on_the_card(cuda):
    """CompositeTiles launches K1 forward and K2 backward and gives the
    CPU's gradient (both plain versions there)."""
    packed, tx, T = _tile_setup(cuda, 64, 4, F=2)
    g = torch.randn(packed.shape[0], 256, 3, device=cuda)
    x = packed.clone().requires_grad_(True)
    f0, b0 = st.composite_tiles.launches, st.composite_tiles_bwd.launches
    (st.CompositeTiles.apply(x, tx, T) * g).sum().backward()
    torch.cuda.synchronize()
    assert (st.composite_tiles.launches, st.composite_tiles_bwd.launches) == (f0 + 1, b0 + 1)
    xc = packed.cpu().requires_grad_(True)
    (st.CompositeTiles.apply(xc, tx, T) * g.cpu()).sum().backward()
    assert _bwd_close(x.grad.cpu(), xc.grad)


def test_tile_bwd_wrapper_validates(cuda):
    p = torch.zeros(2, 9, 4, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        st.composite_tiles_bwd(p, torch.zeros(2, 256, 3, dtype=torch.float16, device=cuda), 2)
    with pytest.raises(ValueError, match="contiguous"):
        st.composite_tiles_bwd(torch.zeros(2, 4, 9, device=cuda).transpose(1, 2),
                               torch.zeros(2, 256, 3, device=cuda), 2)


@pytest.mark.parametrize("B,H,Sq,Skv,masked", [
    (1, 2, 9, 13, False),      # ragged: fewer queries and keys than a block
    (2, 1, 130, 77, True),     # ragged edges, masks, one batch all masked
    (1, 2, 64, 640, True),     # several key blocks
    (2, 2, 200, 64, False),    # several query blocks over one key block
    (1, 2, 40, 129, False),    # Sq < 64; one key past a 128-key block edge
    (2, 2, 80, 129, True),     # Sq = 80, one batch all masked, a key past the edge
    (1, 1, 6304, 6304, False), # the audio length: 49 blocks of 128 keys + 32
    (2, 1, 3152, 6304, False), # final_tail: Sq != Skv
])
def test_attention_bwd_kernel_matches_plain(cuda, B, H, Sq, Skv, masked):
    g = torch.Generator(device=cuda).manual_seed(1)

    def rnd(s):
        return torch.randn(B, H, s, 64, generator=g, device=cuda).to(torch.bfloat16)

    q, k, v, dout = rnd(Sq), rnd(Skv), rnd(Skv), rnd(Sq)
    mask = None
    if masked:
        lengths = torch.tensor([Skv // 3] + [0] * (B - 1), device=cuda)
        mask = torch.arange(Skv, device=cuda)[None, :] < lengths[:, None]
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    f0, b0 = at.attention.launches, at.attention_bwd.launches
    out = at.AttentionFunction.apply(qa, ka, va, 0.125, mask)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (at.attention.launches, at.attention_bwd.launches) == (f0 + 1, b0 + 1)
    assert torch.equal(out, at.attention(q, k, v, 0.125, mask))
    want = at.attention_bwd_plain(q.float(), k.float(), v.float(), 0.125, mask, dout.float())
    for name, got, ref in zip(("dq", "dk", "dv"), (qa.grad, ka.grad, va.grad), want):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape, name
        assert at.excess_error(got, ref) <= 1.0, (name, at.excess_error(got, ref))


def test_attention_bwd_kernel_is_deterministic(cuda):
    """dQ comes from its own pass, not from atomics: two launches on the
    same inputs give dQ, dK and dV bit for bit (ragged, masked)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    B, H, Sq, Skv = 2, 2, 300, 333
    q, dout = (torch.randn(B, H, Sq, 64, generator=g, device=cuda).bfloat16() for _ in range(2))
    k, v = (torch.randn(B, H, Skv, 64, generator=g, device=cuda).bfloat16() for _ in range(2))
    mask = torch.arange(Skv, device=cuda)[None, :] < torch.tensor([200, 333], device=cuda)[:, None]
    out, stats = at._attention_kernel(q, k, v, 0.125, mask, True)
    first = at.attention_bwd(q, k, v, 0.125, mask, out, stats, dout)
    second = at.attention_bwd(q, k, v, 0.125, mask, out, stats, dout)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_attention_bwd_wrapper_validates(cuda):
    q = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16, device=cuda)
    stats = torch.zeros(1, 1, 8, 2, device=cuda)
    with pytest.raises(ValueError, match="stats"):
        at.attention_bwd(q, q, q, 0.125, None, q, stats.double(), q)
    with pytest.raises(ValueError, match="dout"):
        at.attention_bwd(q, q, q, 0.125, None, q, stats, q.float())


@pytest.mark.parametrize("gn", [False, True])
@pytest.mark.parametrize("padding,shape", [("SAME", (3, 12, 20, 128)),
                                           ("VALID", (5, 20, 18, 256)),
                                           ("SAME", (7, 8, 8, 128)),
                                           ("VALID", (300, 20, 20, 256)),
                                           ("VALID", (40, 20, 20, 128)),
                                           ("SAME", (2, 40, 70, 128)),
                                           ("VALID", (2, 36, 70, 256)),
                                           ("SAME", (1, 20, 32, 256)),
                                           ("SAME", (1, 18, 34, 128)),
                                           ("SAME", (2, 16, 64, 128)),
                                           ("SAME", (1, 32, 32, 256))])
def test_winograd_kernels_match_plain(cuda, gn, padding, shape):
    """K9a / K9b at tile counts that are not a multiple of the block's 128
    tiles (180, 360, 112, 24300, 3240), blocks that span images (K9a: 7
    images of 16 tiles; the serving path's VALID convs of many 20^2
    windows), the SAME border (with GN: zero after the affine), K = 128 and
    256; and the rectangle kernel's 2 x 32 and 4 x 16 tile rectangles: rows
    of 35 and 34 tiles that fill one 32-wide rectangle and spill into a
    second, 16 tiles wide (the 16-wide rectangle) and 17 (the 32-wide one),
    tile-row counts that leave the last rectangle part empty (17, 9, 10, 6),
    odd rectangle counts (a cluster block without tiles: 7, 3, 5); images
    the rectangles tile exactly (8 x 32 and 16 x 16 tiles), where K9a also
    runs the rectangle kernel."""
    g = torch.Generator(device=cuda).manual_seed(5)
    N, C = shape[0], shape[-1]
    K = 128 if C == 256 else 256
    x = torch.randn(*shape, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn(3, 3, C, K, generator=g, device=cuda) / (9 * C) ** 0.5).to(torch.bfloat16)
    b = (0.1 * torch.randn(K, generator=g, device=cuda)).to(torch.bfloat16)
    a = 1.0 + 0.3 * torch.randn(N, C, generator=g, device=cuda)
    c = 0.3 * torch.randn(N, C, generator=g, device=cuda)
    if gn:
        fn, plain, counter = wg.winograd_conv3x3_gn_relu, wg.winograd_conv3x3_gn_relu_plain, \
            wg.winograd_conv3x3_gn_relu
        args = (x, w, b, a, c, padding)
        h = torch.relu(x.float() * a[:, None, None] + c[:, None, None]).to(x.dtype)
    else:
        fn, plain, counter = wg.winograd_conv3x3, wg.winograd_conv3x3_plain, wg.winograd_conv3x3
        args, h = (x, w, b, padding), x
    direct = torch.nn.functional.conv2d(h.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b,
                                        padding=1 if padding == "SAME" else 0)
    before = counter.launches
    got = fn(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    excess, mean = wg.excess_error(got, want, direct.permute(0, 2, 3, 1))
    assert excess <= 1.0 and mean <= 1.0, (excess, mean)


def test_winograd_wrapper_validates(cuda):
    """The kernels take bf16 operands: fp32 raises, as does a width that is
    not a multiple of 128; the fp32 build of a Winograd configuration is
    refused."""
    from audio_motion_avatar_tpu_torch.models.config import AvatarConfig, serving_config
    from audio_motion_avatar_tpu_torch.serve import build_rollout
    x = torch.zeros(1, 8, 8, 128, device=cuda)
    w = torch.zeros(3, 3, 128, 128, device=cuda)
    b = torch.zeros(128, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        wg.winograd_conv3x3(x, w, b, "SAME")
    with pytest.raises(ValueError, match="multiples of 128"):
        wg.winograd_conv3x3(x[..., :64].bfloat16(), w[:, :, :64].bfloat16(), b.bfloat16(), "SAME")
    cfg = serving_config(dataclasses.replace(AvatarConfig.tiny(image_size=(32, 32)),
                                             triplane_feature_dim=128, smpl_token_dim=128),
                         upsampler_conv="winograd")
    with pytest.raises(ValueError, match="bf16"):
        build_rollout(cfg, device=cuda)


def test_splash_route_is_kernel_a(cuda):
    """audio_attn_impl 'splash' runs kernel A: the self-attention's output
    on the splash route equals kernel A's on the same q / k / v bit for bit."""
    from audio_motion_avatar_tpu_torch.models.transformer import (Transformer1D, linear,
                                                                 merge_heads, split_heads)
    bf16 = torch.bfloat16
    attn = Transformer1D(1, 2, 64, 128, attn_impl="splash", dtype=bf16).to(cuda).block_0.attn1
    x = torch.randn(2, 300, 128, device=cuda, generator=torch.Generator(device=cuda).manual_seed(6))
    with torch.no_grad():
        q, k, v = (split_heads(linear(x, layer, bf16), 2) for layer in (attn.q, attn.k, attn.v))
        before = at.attention.launches
        got = attn(x)
        assert at.attention.launches == before + 1
        want = linear(merge_heads(at.attention(q, k, v, 0.125)), attn.out, bf16)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _sfc_clouds(cuda, B, N, seed):
    """(B, N, 3) float32 clouds with the last eighth of the rows zero
    padding, masked: continuous coordinates (negative ones among them),
    whole cells from -300 to 1500 a side (grid 0, 1023 and clamped), points
    at k / 100 (on the cell edges, where the product's rounding decides the
    cell), and positive-only coordinates (the padding sets the minimum)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    n_valid = N - N // 8
    kinds = [torch.randn(n_valid, 3, generator=g, device=cuda) * 0.6,
             (torch.randint(-300, 1500, (n_valid, 3), generator=g, device=cuda) + 0.5) / 100,
             torch.randint(-500, 500, (n_valid, 3), generator=g, device=cuda) / 100,
             torch.rand(n_valid, 3, generator=g, device=cuda) * 2 + 0.5]
    pts = torch.zeros(B, N, 3, device=cuda)
    for b in range(B):
        pts[b, :n_valid] = kinds[b % len(kinds)]
    return pts, torch.arange(N, device=cuda) < n_valid


@pytest.mark.parametrize("B,N,orders", [
    (6, 30720, ser.ORDERS), (6, 30208, ser.ORDERS), (6, 7680, ser.ORDERS[1:]),
    (6, 2048, ser.ORDERS[1:]), (6, 512, ser.ORDERS[1:]), (6, 128, ser.ORDERS[1:]),
    (1, 30720, ser.ORDERS),
    (3, 333, ("hilbert-trans", "z")),
])
def test_sfc_codes_kernel_bit_exact(cuda, B, N, orders):
    """Kernel SFC against its plain version (on the card and on the CPU)
    bit for bit at PTv3's serving levels (6 clouds of 30,720 and of 30,208
    points, then pooled by 4 and padded to the patch of 512), one cloud (the
    reconstruction), a ragged N and orders in another sequence; a second
    launch alike; the launch counter one a call."""
    pts, mask = _sfc_clouds(cuda, B, N, seed=N)
    before = ser.sfc_codes.launches
    got = ser.sfc_codes(pts, mask, 100.0, orders)
    again = ser.sfc_codes(pts, mask, 100.0, orders)
    assert ser.sfc_codes.launches == before + 2
    want = ser.sfc_codes_plain(pts, mask, 100.0, orders)
    cpu = ser.sfc_codes_plain(pts.cpu(), mask.cpu(), 100.0, orders)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (len(orders), B, N)
    assert torch.equal(got, want) and torch.equal(again, want)
    assert torch.equal(cpu, want.cpu())
    assert bool((got[:, :, ~mask] == ser.PAD_CODE).all())
    # the default call is depth 10, the bits of a depth-10 call
    assert torch.equal(got, ser.sfc_codes(pts, mask, 100.0, orders, 10))


@pytest.mark.parametrize("depth", [1, 3, 8, 9])
def test_sfc_codes_kernel_at_depth(cuda, depth):
    """Kernel SFC at a depth below 10 (PT-v3m1's adaptive depth) against its
    plain version on the card and on the CPU, bit for bit."""
    pts, mask = _sfc_clouds(cuda, 4, 4096, seed=depth)
    got = ser.sfc_codes(pts, mask, 100.0, ser.ORDERS, depth)
    want = ser.sfc_codes_plain(pts, mask, 100.0, ser.ORDERS, depth)
    cpu = ser.sfc_codes_plain(pts.cpu(), mask.cpu(), 100.0, ser.ORDERS, depth)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(cpu, want.cpu())


def _sc_level(cuda, B, N, seed):
    """One level of B body-like clouds (thick sphere shells of N points, a
    0.8 m across at 1 cm voxels): its voxels' rows (one a voxel), keys and
    the neighbour maps."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    d = torch.randn(B, N, 3, generator=g, device=cuda)
    pts = d / d.norm(dim=-1, keepdim=True) * (0.4 + 0.02 * torch.rand(B, N, 1, generator=g,
                                                                      device=cuda))
    grid = ser.grid_coords(pts, 100.0).reshape(-1, 3)
    cloud = torch.arange(B, device=cuda).repeat_interleave(N)
    keys = torch.unique(sc.voxel_keys(cloud, grid))
    rows = torch.arange(keys.numel(), device=cuda)
    return keys, rows


@pytest.mark.parametrize("C_in,C_out,k,bias", [(768, 32, 5, False), (256, 256, 3, True),
                                               (32, 32, 3, True), (512, 512, 3, True),
                                               (64, 128, 3, False)])
def test_subm_conv_kernel_matches_plain(cuda, C_in, C_out, k, bias):
    """Kernel SC against its plain version's float64 sums on the same bf16
    inputs, under sc.excess_error (<= 1: one bf16 spacing of the value plus
    2^-12 of the RMS): the stem's (768 -> 32, 5^3, no bias) and dec0's
    CPE (256 -> 256, 3^3) at serving shapes (6 clouds of 30,000 points,
    one row a voxel), the other CPE widths at smaller levels; a second
    launch bit for bit; the launch counter one a call."""
    B, N = (6, 30000) if C_in in (768, 256) else (3, 2000)
    keys, rows = _sc_level(cuda, B, N, seed=C_in + k)
    nbr = sc.neighbour_map(keys, rows, k)
    g = torch.Generator(device=cuda).manual_seed(k)
    M = rows.numel()
    x = torch.randn(M, C_in, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn(C_out, k, k, k, C_in, generator=g, device=cuda)
         / (k ** 3 * C_in) ** 0.5).to(torch.bfloat16)
    b = torch.randn(C_out, generator=g, device=cuda) if bias else None
    before = sc.subm_conv.launches
    with torch.no_grad():
        got = sc.subm_conv(x, nbr, w, b)
        again = sc.subm_conv(x, nbr, w, b)
    assert sc.subm_conv.launches == before + 2
    want = sc.subm_conv_plain(x.double(), nbr, w.double(), None if b is None else b.double())
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (M, C_out)
    assert torch.equal(got, again)
    assert sc.excess_error(got, want) <= 1.0
    assert 0 < int((nbr >= 0).sum()) < nbr.numel()


def test_subm_conv_ragged_rows_and_absent_neighbours(cuda):
    """Rows past a multiple of 64, rows with no neighbour but themselves,
    and a map that gathers from a larger x (a level's voxels' first rows)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(500, 64, generator=g, device=cuda).to(torch.bfloat16)
    nbr = torch.randint(-1, 500, (131, 27), generator=g, device=cuda).to(torch.int32)
    nbr[:40] = -1
    nbr[:40, 13] = torch.arange(40, device=cuda, dtype=torch.int32)
    w = torch.randn(64, 3, 3, 3, 64, generator=g, device=cuda).to(torch.bfloat16) / 40
    with torch.no_grad():
        got = sc.subm_conv(x, nbr, w, None)
    want = sc.subm_conv_plain(x.double(), nbr, w.double())
    torch.cuda.synchronize()
    assert sc.excess_error(got, want) <= 1.0


@pytest.mark.parametrize("C_in,C_out,k,bias", [(768, 32, 5, False), (256, 256, 3, True)])
def test_subm_conv_backward_kernel(cuda, C_in, C_out, k, bias):
    """SC under autograd on the card (the stem's and a CPE's widths, 2
    clouds of 5,000 points, two rows a voxel of which the second is read by
    no map): forward and dx by kernel SC (two launches), dW and db against
    autograd through the plain version in float64 on the same bf16 inputs;
    dx and dW under sc.excess_error, db (fp32 sums over the voxels) within
    1e-5 relative; rows that represent no voxel get 0."""
    keys, rows = _sc_level(cuda, 2, 5000, seed=k)
    nbr = sc.neighbour_map(keys, 2 * rows, k)
    g = torch.Generator(device=cuda).manual_seed(k)
    x = torch.randn(2 * rows.numel(), C_in, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn(C_out, k, k, k, C_in, generator=g, device=cuda)
         / (k ** 3 * C_in) ** 0.5).to(torch.bfloat16)
    b = torch.randn(C_out, generator=g, device=cuda) if bias else None
    dy = torch.randn(rows.numel(), C_out, generator=g, device=cuda).to(torch.bfloat16)
    leaves = [t.requires_grad_() for t in (x, w, b) if t is not None]
    before = sc.subm_conv.launches
    got = torch.autograd.grad(sc.subm_conv(x, nbr, w, b), leaves, dy)
    assert sc.subm_conv.launches == before + 2
    ref_leaves = [t.detach().double().requires_grad_() for t in leaves]
    want = torch.autograd.grad(sc.subm_conv_plain(ref_leaves[0], nbr, ref_leaves[1],
                                                  ref_leaves[2] if bias else None),
                               ref_leaves, dy.double())
    torch.cuda.synchronize()
    assert got[0].dtype == torch.bfloat16 and bool((got[0][1::2] == 0).all())
    assert sc.excess_error(got[0], want[0]) <= 1.0
    assert sc.excess_error(got[1], want[1]) <= 1.0
    if bias:
        torch.testing.assert_close(got[2].double(), want[2], rtol=1e-5, atol=0)


def test_subm_conv_wrapper_validates(cuda):
    x = torch.zeros(10, 32, device=cuda, dtype=torch.bfloat16)
    nbr = torch.zeros(10, 27, device=cuda, dtype=torch.int32)
    w = torch.zeros(32, 3, 3, 3, 32, device=cuda)
    with torch.no_grad():
        with pytest.raises(ValueError, match="bf16"):
            sc.subm_conv(x.float(), nbr, w)
        with pytest.raises(ValueError, match="int32"):
            sc.subm_conv(x, nbr.long(), w)
        with pytest.raises(ValueError, match="multiples of 32"):
            sc.subm_conv(x[:, :16].contiguous(), nbr, w[..., :16])
        with pytest.raises(ValueError, match="does not fit"):
            sc.subm_conv(x, nbr[:, :8].contiguous(), w)


def test_sfc_codes_wrapper_validates(cuda):
    pts, mask = _sfc_clouds(cuda, 2, 64, seed=0)
    with pytest.raises(ValueError, match="float32"):
        ser.sfc_codes(pts.half(), mask, 100.0, ser.ORDERS)
    with pytest.raises(ValueError, match="contiguous"):
        ser.sfc_codes(pts.transpose(0, 1).contiguous().transpose(0, 1), mask, 100.0, ser.ORDERS)
    with pytest.raises(ValueError, match="contiguous"):
        ser.sfc_codes(pts[..., :2], mask, 100.0, ser.ORDERS)
    with pytest.raises(ValueError, match="mask"):
        ser.sfc_codes(pts, mask.to(torch.uint8), 100.0, ser.ORDERS)
    with pytest.raises(ValueError, match="mask"):
        ser.sfc_codes(pts, mask[:-1], 100.0, ser.ORDERS)
    with pytest.raises(ValueError, match="orders"):
        ser.sfc_codes(pts, mask, 100.0, ["hilbert", "peano"])
    with pytest.raises(ValueError, match="orders"):
        ser.sfc_codes(pts, mask, 100.0, [])
