"""The FLOP and byte arithmetic, and FlopCounterMode's counts of the
reference's work, against counts by hand at small shapes."""

import pytest
import torch

from benchmark.chip import PEAK_BF16_FLOPS, PEAK_BYTES, bound_ms
from benchmark.reference.plain_avatar.ops.attention import attention_plain
from benchmark.reference.plain_avatar.ops.calls import record
from benchmark.reference.plain_avatar.ops.triplane import quad_rows_plain
from benchmark.reference.plain_avatar.ops.splat_segmented import composite_segments_plain
from benchmark.reference.plain_avatar.ops.splat_tiles import composite_tiles_plain
from benchmark.work import attention_work, counted_flops, kernel_bound_ms, quad_rows_work


def test_attention_work_by_hand():
    call = {"q": (2, 8, 3152, 64), "k": (2, 8, 6304, 64), "v": (2, 8, 6304, 64),
            "scale": 0.125, "kv_mask": None}
    flops, nbytes = attention_work([call])
    assert flops == 4 * 2 * 8 * 3152 * 6304 * 64
    assert nbytes == 2 * 2 * 8 * 64 * (3152 * 2 + 6304 * 2)
    masked = dict(call, kv_mask=(2, 6304))
    assert attention_work([masked])[1] == nbytes + 2 * 6304


def test_quad_rows_work_by_hand():
    flops, nbytes = quad_rows_work([{"tiles": (36, 256, 16, 16, 256), "slot": (36, 1024),
                                     "grid": 32}])
    assert flops == 0
    assert nbytes == 2 * (36 * 256 * 16 * 16 * 256) * (1 + 4)


def test_bound_is_the_larger_time():
    assert bound_ms(PEAK_BF16_FLOPS, 0) == pytest.approx(1e3)
    assert bound_ms(0, PEAK_BYTES) == pytest.approx(1e3)
    assert kernel_bound_ms(quad_rows_work, [{"tiles": (1, 1, 1, 1, 1)}]) == \
        pytest.approx(10 / PEAK_BYTES * 1e3)


def test_flop_counter_counts_attention_and_linear():
    g = torch.Generator().manual_seed(0)
    B, H, Sq, Skv, D = 1, 2, 1500, 40, 64       # Sq spans two query blocks
    q = torch.randn(B, H, Sq, D, generator=g)
    k = torch.randn(B, H, Skv, D, generator=g)
    v = torch.randn(B, H, Skv, D, generator=g)
    lin = torch.nn.Linear(64, 32)
    x = torch.randn(10, 64, generator=g)
    with record() as log:
        n = counted_flops(lambda: (attention_plain(q, k, v, 0.125), lin(x)))
    assert n == 4 * B * H * Sq * Skv * D + 2 * 10 * 64 * 32
    assert log["attention"] == [{"q": (B, H, Sq, D), "k": (B, H, Skv, D), "v": (B, H, Skv, D),
                                 "scale": 0.125, "kv_mask": None}]


def test_blocked_attention_is_exact():
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 2, n, 64, generator=g, dtype=torch.float64) for n in (2100, 300, 300))
    mask = torch.rand(1, 300, generator=g) > 0.2
    logits = torch.einsum("bhsd,bhtd->bhst", q, k) * 0.125
    logits = logits.masked_fill(~mask[:, None, None, :], -1e30)
    want = torch.einsum("bhst,bhtd->bhsd", torch.softmax(logits, -1), v)
    torch.testing.assert_close(attention_plain(q, k, v, 0.125, mask), want, rtol=1e-12, atol=1e-12)


def test_quad_rows_logged():
    tiles = torch.zeros(3, 4, 2, 2, 8)
    slot = torch.full((3, 9), -1, dtype=torch.int64)
    slot[:, :4] = torch.arange(4)
    with record() as log:
        quad_rows_plain(tiles, slot, 3)
    assert log["quad_rows"] == [{"tiles": (3, 4, 2, 2, 8), "slot": (3, 9), "grid": 3}]


def test_splat_composites_logged():
    # every call that stands where the port launches a kernel logs its
    # arguments, so a later roofline brings only its own work function
    params = torch.zeros(9, 5)
    params[5] = 0.5
    starts = torch.tensor([0, 2], dtype=torch.int32)
    counts = torch.tensor([2, 3], dtype=torch.int32)
    with record() as log:
        composite_segments_plain(params, starts, counts, 2, 2)
        composite_tiles_plain(torch.zeros(2, 9, 4), 2)
    assert log["composite_segments"] == [{"params": (9, 5), "starts": (2,), "counts": (2,),
                                          "tx": 2, "tiles_per_frame": 2}]
    assert log["composite_tiles"] == [{"tile_params": (2, 9, 4), "tx": 2, "tiles_per_frame": 0}]
