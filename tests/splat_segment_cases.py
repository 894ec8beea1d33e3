"""Hand-made inputs of kernel S (ops/splat_segmented.composite_segments)
that reach its edges, shared by the CPU test of its walk
(tests/test_torch_splat.py) and its GPU test (tests/test_torch_kernels_gpu.py).
Imports no JAX, so the GPU tests can run without it."""

import numpy as np
import torch

TX, TY, FRAMES = 4, 2, 2
# segment length of each tile of frame 0; frame 1's are drawn in [0, 200]
EDGE_COUNTS = {"empty": 0, "one chunk": 128, "one more": 129, "three chunks": 300,
               "K": 512, "all dropped": 160, "saturated": 254, "one": 1}


def _gaussians(rng, n, ox, oy):
    """(9, n) params [mx, my, cxx, cxy, cyy, op, r, g, b] scattered around
    the tile at (ox, oy), some off it; conics from broad to point-like."""
    p = np.zeros((9, n), np.float32)
    p[0] = ox + rng.uniform(-6, 22, n)
    p[1] = oy + rng.uniform(-6, 22, n)
    scale = np.exp(rng.uniform(np.log(0.01), np.log(3.0), n))
    p[2] = scale * rng.uniform(0.5, 1.5, n)
    p[4] = scale * rng.uniform(0.5, 1.5, n)
    p[3] = 0.3 * np.sqrt(p[2] * p[4]) * rng.uniform(-1, 1, n)
    p[5] = rng.uniform(0.05, 0.99, n)
    p[6:9] = rng.uniform(0, 1, (3, n))
    return p


def edge_segments(device, seed=0):
    """(params (9, NP), starts, counts, tx, tiles_per_frame) of 2 frames of
    4 x 2 tiles. Frame 0's tiles hold the segments of EDGE_COUNTS in order:
    no entry, exactly one 128-entry chunk, one entry more, three chunks, K =
    512, 160 entries of which every pair is dropped (opacity under 1/255,
    means far off the tile, or power > 0 from a conic that is not positive),
    a segment whose first 4 entries are broad and opaque, so that every
    pixel falls under T 1e-4 before the remaining 250 entries, and a single
    entry. The segments lie in the payload in shuffled order with 0 to 7
    entries of other data between them, so no start is aligned."""
    rng = np.random.RandomState(seed)
    tpf = TX * TY
    counts = list(EDGE_COUNTS.values()) + list(rng.randint(0, 201, tpf))
    segs = []
    for t, n in enumerate(counts):
        tid = t % tpf
        p = _gaussians(rng, n, (tid % TX) * 16, (tid // TX) * 16)
        if t == 5:                                  # every pair dropped
            third = n // 3
            p[5, :third] = rng.uniform(0, 1 / 255 * 0.99, third)
            p[0, third:2 * third] += 1e4
            p[2, 2 * third:] = -np.abs(p[2, 2 * third:]) - 0.1
            p[4, 2 * third:] = -np.abs(p[4, 2 * third:]) - 0.1
            p[3, 2 * third:] = 0.0
        if t == 6:                                  # T under 1e-4 after 4
            p[0, :4], p[1, :4] = (t % TX) * 16 + 8.0, (t // TX) * 16 + 8.0
            p[2:5, :4] = [[1e-3], [0.0], [1e-3]]
            p[5, :4] = 1.0
        segs.append(p)
    NP = sum(counts) + 8 * len(counts)
    params = rng.uniform(-1, 2, (9, NP)).astype(np.float32)
    starts = np.zeros(len(counts), np.int32)
    pos = 0
    for t in rng.permutation(len(counts)):
        pos += rng.randint(0, 8)
        starts[t] = pos
        params[:, pos:pos + counts[t]] = segs[t]
        pos += counts[t]

    def t_(a):
        return torch.as_tensor(a, device=device)
    return (t_(params), t_(starts), t_(np.asarray(counts, np.int32)), TX, tpf)
