"""The port's space-filling-curve codes (ops/serialization.py) against the
JAX package's, and PTv3's batched sort of them (models/ptv3._orders)
against one stable argsort an order. Exact: the codes are integers.
Kernel SFC itself is held to the plain version on the card
(tests/test_torch_kernels_gpu.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_motion_avatar_tpu.ops import serialization as jser

from audio_motion_avatar_tpu_torch.models import ptv3
from audio_motion_avatar_tpu_torch.ops import serialization as ser
from torch_parity import one_torch_thread  # noqa: F401

RES = 100.0


def clouds(seed, B=3, N=400, n_valid=350):
    """(B, N, 3) float32 clouds, rows from n_valid on zero padding (as PTv3
    pads), and the (N,) mask. Cloud 0: continuous coordinates, negative
    ones among them; cloud 1: whole grid cells (each point at a cell's
    centre) from -300 to 1500 a side, so that its grid reads exactly 0 and
    1023 and past 1023 (clamped); cloud 2: only positive coordinates, so
    that the zero padding rows set its minimum."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((B, N, 3), np.float32)
    pts[0, :n_valid] = rng.randn(n_valid, 3) * 2.0
    cells = rng.randint(-300, 1500, size=(n_valid, 3))
    cells[:3] = [[-300, -300, -300], [723, 723, 723], [724, 1500, -300]]
    pts[1, :n_valid] = (cells + 0.5) / RES
    pts[2, :n_valid] = rng.rand(n_valid, 3) * 5.0 + 1.0
    mask = np.arange(N) < n_valid
    return pts, mask


def jax_codes(pts, mask, order):
    """The JAX package's codes, a cloud at a time (its PTv3 vmaps over
    clouds), PAD_CODE where masked."""
    out = []
    for cloud in pts:
        code = jser.encode(jser.grid_coords(jnp.asarray(cloud), RES), order)
        out.append(np.where(mask, np.asarray(code), ser.PAD_CODE))
    return np.stack(out)


@pytest.mark.parametrize("order", ser.ORDERS)
def test_codes_match_jax(order):
    pts, mask = clouds(0)
    got = ser.sfc_codes(torch.as_tensor(pts), torch.as_tensor(mask), RES, [order])
    assert got.dtype == torch.int32 and got.shape == (1,) + pts.shape[:2]
    np.testing.assert_array_equal(got[0].numpy(), jax_codes(pts, mask, order))
    assert (got[0][:, ~torch.as_tensor(mask)] == ser.PAD_CODE).all()
    grid = ser.grid_coords(torch.as_tensor(pts), RES)
    assert {0, 1023} <= set(grid[1, :350].flatten().tolist())       # the edges
    assert int(grid[2, :350].min()) > 0                              # min at the padding


def test_all_orders_in_one_call():
    """Every order at once equals the orders one at a time, in the order asked."""
    pts, mask = clouds(1)
    p, m = torch.as_tensor(pts), torch.as_tensor(mask)
    names = ("hilbert-trans", "z", "hilbert")
    got = ser.sfc_codes(p, m, RES, names)
    for k, o in enumerate(names):
        assert torch.equal(got[k], ser.sfc_codes_plain(p, m, RES, [o])[0])


def crowded_clouds(seed, N=1100, n_valid=1024):
    """Clouds whose codes crowd: every cell of an 8^3 block twice (every
    code of a range present, equal in pairs), 64 cells 16 times each, and
    random points on a coarse lattice; rows shuffled, the rest padding."""
    rng = np.random.RandomState(seed)
    block = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pts = np.zeros((3, N, 3), np.float32)
    pts[0, :n_valid] = (np.concatenate([block, block])[rng.permutation(n_valid)] + 0.5) / RES
    pts[1, :n_valid] = (np.repeat(block[::8], 16, 0)[rng.permutation(n_valid)] * 3 + 0.5) / RES
    pts[2, :n_valid] = np.round(rng.randn(n_valid, 3)) * 0.5
    return pts, np.arange(N) < n_valid


@pytest.mark.parametrize("names", [ser.ORDERS, ser.ORDERS[1:]])
def test_orders_batched_sort_matches_argsort(names):
    """_orders' one sort over (K B, N) and one inverse give, for every
    order, the stable argsort of its codes and that permutation's inverse,
    on clouds of crowded and equal codes (where the order of a tie and of
    neighbouring codes both show)."""
    pts, mask = crowded_clouds(2)
    p, m = torch.as_tensor(pts), torch.as_tensor(mask)
    got = ptv3._orders(p, m, RES, names)
    assert list(got) == list(names)
    for o in names:
        code = ser.sfc_codes_plain(p, m, RES, [o])[0]
        assert len(torch.unique(code)) < code.numel() // 2
        perm = torch.argsort(code, dim=1, stable=True)
        assert torch.equal(got[o][0], perm)
        assert torch.equal(got[o][1], ptv3.invert_perm(perm))
        assert torch.equal(torch.gather(got[o][0], 1, got[o][1]),
                           torch.arange(code.shape[1]).expand_as(perm))
