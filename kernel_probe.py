#!/usr/bin/env python3
"""Phase probes of kernels S (segmented splat), K1 (tile splat) and K9a /
K9b (Winograd) on one NVIDIA GPU (H100), for tuning; chip_smoke.py is the
check of record.

    python3 kernel_probe.py [--parent DIR] [--only s,k1,winograd]

Builds, besides the port's libraries, probe builds of csrc/splat_segments.cu
(-DSPLAT_SEGMENTS_PROBE: a mask skips its walk, staging, tile-order
pre-pass or far-pair cut; an order array maps blocks to tiles),
csrc/splat_tiles.cu (-DSPLAT_TILES_PROBE: a mask skips its walk, staging or
far-pair cut) and
csrc/winograd.cu
(-DWINOGRAD_PROBE: a device mask skips the region's copies, the GroupNorm
affine, the input transform, the products or U's copies after the first
two chunks; a timeline of one cluster's SM clock) into
build/probe/, all nvcc processes started together, and with --parent DIR
(an earlier tree's audio_motion_avatar_tpu_torch/csrc unpacked under DIR)
that tree's S, K1 and K9a / K9b. Then, through this tree's wrappers
(chip_smoke.through; the parent's S by chip_smoke.parent_segments):
  S at chip_smoke's serving shape (6 frames at 512^2, 30k gaussians, K =
     512): the segment lengths; max|diff| against the plain version,
     bit-equality with a second launch and the parent's output; CUDA-event
     times in turns; the probe build in the pre-pass's tile order, in the
     tiles' own order and in argsort's, with the walk skipped (staging and
     stores), with the staging skipped too (with and without the pre-pass),
     without the far-pair cut; the shares of kept, far and other dropped
     pairs; and the longest tile alone (the other counts set to 0);
  K1 at chip_smoke's two shapes (1 + 8 views at 1024^2, one 1296x2304
     frame; K = 512): max|diff| against the plain version, bit-equality
     with a second launch and the parent's output; CUDA-event times in
     turns, and the probe build whole, with the walk skipped (scan, staging
     and stores), with the staging skipped too (scan and stores), and
     without the far-pair cut;
  K9b at (3, 512^2, 256) and (18, 256^2, 256) SAME, K9a at (18, 256^2,
     256) SAME and at the two VALID shapes of chip_smoke (4608 windows of
     20^2 and 18^2): with --parent, the parent's time in turns and
     bit-equality with its output; the time with each phase mask and the
     rectangle kernel's per-chunk timeline in SM cycles (the SAME shapes);
     and the wrapper's U = G w G^T (ops/winograd.kernel_u) alone.
Every time is a CUDA-event mean; the card's name and power limit are
printed first.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# the rectangle kernel's probe masks (csrc/winograd.cu SKIP_*): the region's
# copies 1, the affine 2, the transform 4, the products 8, U after the
# first two chunks 32
WINOGRAD_MASKS = [(0, "full"), (2, "no affine"), (1, "no region copies"), (4, "no transform"),
                  (32, "U loaded twice"), (8, "no products"), (12, "copies and affine alone"),
                  (7, "products alone"), (15, "none of the phases"), (47, "none, U twice")]


def build_variants(variants):
    """{tag: (source path, nvcc flags of that kernel, extra defines)} ->
    {tag: library path}, every nvcc started together."""
    from audio_motion_avatar_tpu_torch import kernels
    out_dir = os.path.join(ROOT, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for tag, (src, flags, defines) in variants.items():
        out = os.path.join(out_dir, f"lib{tag}.so")
        cmd = [kernels._nvcc(), *kernels._BASE_FLAGS, *flags, *defines, "-o", out, src]
        procs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), out)
    paths = {}
    for tag, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        paths[tag] = out
    return paths


def load(path, name, extra=()):
    import ctypes
    from audio_motion_avatar_tpu_torch import kernels
    lib = ctypes.CDLL(path)
    for fn, (argtypes, restype) in kernels.KERNELS[name][2].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
    for fn in extra:
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = [ctypes.c_int], ctypes.c_int
    return lib


def pair_shares(params, starts, counts, tx, tiles_per_frame):
    """What the walk makes of S's (pixel, segment entry) pairs, followed
    along each segment as the plain version does: the shares kept, kept with
    T already under T_EPS (whose exp of log T no weight needs), and of those
    in a warp whose 32 pixels are all under it; dropped at power < -5.6 with
    opacity <= 1 (the far-pair cut, before the exp); dropped otherwise; and
    the share of segment entries far from every pixel of their tile."""
    import torch
    from audio_motion_avatar_tpu_torch.ops import splat as sp

    n = starts.shape[0]
    npix = sp.TILE * sp.TILE
    px, py = sp.tile_pixels(n, tx, tiles_per_frame, params.device)
    c = counts.long()
    logT = torch.zeros(n, npix, device=params.device)
    T = torch.ones(n, npix, device=params.device)
    kept = under = warp_under = far = far_entries = 0
    for j in range(int(c.max())):
        walked = j < c
        g = params[:, torch.where(walked, starts.long() + j, 0)]
        _, _, power, _, _, alpha, keep = sp.slot_alpha(g, px, py)
        k = keep & walked[:, None]
        is_under = T < sp.T_EPS
        kept += int(k.sum())
        under += int((k & is_under).sum())
        warp_all = is_under.view(n, npix // 32, 32).all(-1, keepdim=True).expand(-1, -1, 32)
        warp_under += int((k & warp_all.reshape(n, npix)).sum())
        is_far = (power < -5.6) & (g[5] <= 1.0)[:, None] & walked[:, None]
        far += int(is_far.sum())
        far_entries += int((is_far.all(-1) & walked).sum())
        logT_after = logT + torch.log1p(-alpha)
        logT = torch.where(k, logT_after, logT)
        T = torch.where(k, torch.exp(logT_after), T)
    pairs = int(c.sum()) * npix
    return (f"{pairs} pairs; kept {kept / pairs:.4f} (of them with T under T_EPS "
            f"{under / max(kept, 1):.4f}, in a warp all under it {warp_under / max(kept, 1):.4f}), "
            f"dropped at power < -5.6 {far / pairs:.4f}, dropped otherwise "
            f"{(pairs - kept - far) / pairs:.4f}; segment entries far from their whole tile "
            f"{far_entries / int(c.sum()):.4f}")


def probe_s(dev, libs):
    import ctypes
    import torch
    import chip_smoke as cs
    from audio_motion_avatar_tpu_torch.ops import splat_segmented as ss

    args = cs.segment_inputs(dev)[0]
    params, starts, counts = args[:3]
    c = counts.long()
    chunks = torch.bincount((c + 127) // 128, minlength=5).tolist()
    q = torch.quantile(c[c > 0].double(),
                       torch.tensor([0.5, 0.9, 0.99], device=dev, dtype=torch.double))
    print(f"[probe] S segments: {c.numel()} tiles, {int((c > 0).sum())} non-empty, "
          f"{int(c.sum())} entries; non-empty lengths median / 90 % / 99 % "
          f"{' / '.join(f'{v:.0f}' for v in q.tolist())}, max {int(c.max())}; tiles of 0, 1, 2, "
          f"3, 4 chunks of 128: {chunks}", flush=True)

    def new():
        return ss.composite_segments(*args)

    runs = {"this tree": new}
    if "parent_segments" in libs:
        runs["parent"] = cs.parent_segments(sys.argv[sys.argv.index("--parent") + 1],
                                            libs["parent_segments"], args)
    out = {k: f() for k, f in runs.items()}
    again = new()
    plain = ss.composite_segments_plain(*args)
    torch.cuda.synchronize()
    ref = out["this tree"]
    err = float((ref - plain).abs().max())
    same = {k: bool(torch.equal(ref, v)) for k, v in out.items()}
    print(f"[probe] S: max|diff| against the plain version {err:.3e}; bit-identical to a second "
          f"launch {torch.equal(ref, again)}, to {same}", flush=True)
    order = list(runs) + list(reversed(runs))
    times = {k: [] for k in runs}
    for k in order:
        times[k].append(cs.time_ms(runs[k], 10))
    print("[probe] S: " + ", ".join(
        f"{k} {' / '.join(f'{t:.4f}' for t in v)} ms" for k, v in times.items()), flush=True)

    probe = libs["segments_probe"]
    probe.splat_segments_probe_order.argtypes = [ctypes.c_void_p]
    probe.splat_segments_probe_order.restype = ctypes.c_int
    run = cs.through("splat_segments", probe, new)
    longest = torch.argsort(counts, descending=True, stable=True).to(torch.int32)
    line = []
    for mask, tile_order, what in ((0, None, "full (the pre-pass's order)"),
                                   (8, None, "own order, no pre-pass"),
                                   (0, longest, "argsort's order, longest first"),
                                   (1, None, "walk skipped"),
                                   (3, None, "walk and staging skipped"),
                                   (11, None, "walk and staging skipped, no pre-pass"),
                                   (16, None, "without the far-pair cut"),
                                   (24, None, "without the cut, own order")):
        probe.splat_segments_probe_set(mask)
        probe.splat_segments_probe_order(None if tile_order is None else tile_order.data_ptr())
        ms = cs.time_ms(run, 10)
        exact = "" if mask & 3 else f" (bit-identical {torch.equal(run(), ref)})"
        line.append(f"{what} {ms:.4f}{exact}")
    probe.splat_segments_probe_set(0)
    probe.splat_segments_probe_order(None)
    print("[probe] S probe build: " + "; ".join(line) + " ms", flush=True)
    print("[probe] S pairs: " + pair_shares(params, starts, counts, *args[3:]), flush=True)
    alone = torch.zeros_like(counts)
    top = int(longest[0])
    alone[top] = counts[top]
    ms = cs.time_ms(lambda: ss.composite_segments(params, starts, alone, *args[3:]), 10)
    print(f"[probe] S: the longest tile ({int(counts[top])} entries) alone, the others empty: "
          f"{ms:.4f} ms", flush=True)
    del out, again, plain
    torch.cuda.empty_cache()


def probe_k1(dev, libs):
    import torch
    import chip_smoke as cs
    from audio_motion_avatar_tpu_torch.ops import splat_tiles as st

    for name, W, H, windows in cs.K2_CASES:
        packed, tx, T, valid = cs.packed_views(dev, W, H, windows)

        def new():
            return st.composite_tiles(packed, tx, T)

        runs = {"this tree": new}
        if "parent" in libs:
            runs["parent"] = cs.through("splat_tiles", libs["parent"], new)
        out = {k: f() for k, f in runs.items()}
        again = new()
        plain = st.composite_tiles_plain(packed, tx, T)
        torch.cuda.synchronize()
        err = float((out["this tree"] - plain).abs().max())
        same = {k: bool(torch.equal(out["this tree"], v)) for k, v in out.items()}
        print(f"[probe] K1 {name} {tuple(packed.shape)}, {valid} live entries: max|diff| against "
              f"the plain version {err:.3e}; bit-identical to a second launch "
              f"{torch.equal(out['this tree'], again)}, to {same}", flush=True)
        order = list(runs) + list(reversed(runs))
        times = {k: [] for k in runs}
        for k in order:
            times[k].append(cs.time_ms(runs[k], 5))
        print("[probe] K1 " + name + ": " + ", ".join(
            f"{k} {' / '.join(f'{t:.4f}' for t in v)} ms" for k, v in times.items()), flush=True)
        probe = libs["probe"]
        for mask, what in ((0, "probe build, full"), (1, "walk skipped (scan, staging, stores)"),
                           (3, "walk and staging skipped (scan, stores)"),
                           (4, "without the far-pair cut")):
            probe.splat_tiles_probe_set(mask)
            run = cs.through("splat_tiles", probe, new)
            ms = cs.time_ms(run, 5)
            exact = "" if mask & 3 else f" (bit-identical {torch.equal(run(), out['this tree'])})"
            print(f"[probe] K1 {name}: {what}: {ms:.4f} ms{exact}", flush=True)
        probe.splat_tiles_probe_set(0)
        del packed, out, again, plain
        torch.cuda.empty_cache()


# the rectangle kernel's timeline (csrc/winograd.cu PROBE_MARK): the
# producer's steps from point 0 to 4, the consumers' from 5 to 7
TIMELINE = ((0, 1, "producer: the region finished"), (1, 2, "waits for a free stage"),
            (2, 3, "U issued, the items"), (3, 4, "the next region issued"),
            (5, 6, "consumers: waits for V and U"), (6, 7, "the products"))


def timeline(probe, run):
    """One launch of the probe build; the mean SM cycles of each step of
    the first 8 chunks of the middle cluster's two blocks, and from chunk to
    chunk (producer, consumers)."""
    import ctypes
    import numpy as np
    import torch
    probe.winograd_probe_clock.argtypes = [ctypes.c_void_p]
    probe.winograd_probe_clock.restype = ctypes.c_int
    run()
    torch.cuda.synchronize()
    clk = np.zeros((2, 8, 8), np.int64)
    probe.winograd_probe_clock(clk.ctypes.data)
    steps = [f"{name} {(clk[0, :, b] - clk[0, :, a]).mean():.0f} / "
             f"{(clk[1, :, b] - clk[1, :, a]).mean():.0f}" for a, b, name in TIMELINE]
    chunk = [np.diff(clk[:, :, p], axis=1).mean(axis=1) for p in (0, 5)]
    return ("timeline (SM cycles a chunk, blocks 0 / 1): " + "; ".join(steps) +
            f"; chunk to chunk: producer {chunk[0][0]:.0f} / {chunk[0][1]:.0f}, consumers "
            f"{chunk[1][0]:.0f} / {chunk[1][1]:.0f}")


def probe_winograd(dev, libs):
    import torch
    import chip_smoke as cs
    from audio_motion_avatar_tpu_torch.ops import winograd as W

    g = torch.Generator(device=dev).manual_seed(4)
    C = K = 256
    w = (torch.randn(3, 3, C, K, device=dev, generator=g) / (9 * C) ** 0.5).to(torch.bfloat16)
    b = (0.1 * torch.randn(K, device=dev, generator=g)).to(torch.bfloat16)
    print(f"[probe] U = G w G^T (kernel_u) at C = K = {C}: {cs.time_ms(lambda: W.kernel_u(w), 20):.4f}"
          f" ms; the bias cast {cs.time_ms(lambda: b.float().contiguous(), 20):.4f} ms",
          flush=True)
    probe = libs["winograd_probe"]
    for kern, N, S, padding in (("K9b", 3, 512, "SAME"), ("K9b", 18, 256, "SAME"),
                                ("K9a", 18, 256, "SAME"), ("K9a", 4608, 20, "VALID"),
                                ("K9a", 4608, 18, "VALID")):
        x = torch.randn(N, S, S, C, device=dev, generator=g).to(torch.bfloat16)
        a = 1.0 + 0.3 * torch.randn(N, C, device=dev, generator=g)
        c = 0.3 * torch.randn(N, C, device=dev, generator=g)

        def new():
            if kern == "K9a":
                return W.winograd_conv3x3(x, w, b, padding)
            return W.winograd_conv3x3_gn_relu(x, w, b, a, c, padding)

        shape = f"{kern} ({N}, {S}^2, {C}) {padding}"
        base = cs.time_ms(new, 5)
        if "parent_winograd" in libs:
            old = cs.through("winograd", libs["parent_winograd"], new)
            got, want = new(), old()
            same = torch.equal(got.view(torch.int16), want.view(torch.int16))
            t = [cs.time_ms(f, 10) for f in (old, new, new, old, old, new)]
            print(f"[probe] {shape}: parent {t[0]:.4f} / {t[3]:.4f} / {t[4]:.4f} ms, this tree "
                  f"{t[1]:.4f} / {t[2]:.4f} / {t[5]:.4f} ms; bit-identical to the parent's output "
                  f"{same}", flush=True)
            del got, want
        if padding == "VALID":   # the raster kernel, not profiled here
            continue
        line = []
        for mask, what in WINOGRAD_MASKS:
            probe.winograd_probe_set(mask)
            line.append(f"{what} {cs.time_ms(cs.through('winograd', probe, new), 5):.4f}")
        probe.winograd_probe_set(0)
        print(f"[probe] {shape}: " + timeline(probe, cs.through("winograd", probe, new)),
              flush=True)
        u_ms = cs.time_ms(lambda: W.kernel_u(w), 10)
        print(f"[probe] {shape}: the shipped build {base:.4f} ms; probe "
              f"build: {'; '.join(line)} ms (each includes U, {u_ms:.4f} ms)", flush=True)
        del x
        torch.cuda.empty_cache()


def main():
    import torch
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from audio_motion_avatar_tpu_torch import kernels
    import chip_smoke as cs

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"[probe] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{smi.stdout.strip()}", flush=True)
    only = (sys.argv[sys.argv.index("--only") + 1].split(",") if "--only" in sys.argv
            else ["s", "k1", "winograd"])
    # probe: (library name, source, probe define, its C setters) of each kernel
    probes = {"s": ("splat_segments", "segments_probe", "-DSPLAT_SEGMENTS_PROBE",
                    ["splat_segments_probe_set"]),
              "k1": ("splat_tiles", "probe", "-DSPLAT_TILES_PROBE", ["splat_tiles_probe_set"]),
              "winograd": ("winograd", "winograd_probe", "-DWINOGRAD_PROBE",
                           ["winograd_probe_set"])}
    parents = {"s": "parent_segments", "k1": "parent", "winograd": "parent_winograd"}
    csrc = kernels.CSRC
    variants, names = {}, [probes[k][0] for k in only]
    for k in only:
        name, tag, define, _ = probes[k]
        src = kernels.KERNELS[name][0]
        variants[tag] = (os.path.join(csrc, src), kernels.KERNELS[name][1], [define])
        if "--parent" in sys.argv:
            parent = sys.argv[sys.argv.index("--parent") + 1]
            psrc = os.path.join(parent, "audio_motion_avatar_tpu_torch", "csrc")
            variants[parents[k]] = (os.path.join(psrc, src), kernels.KERNELS[name][1], [])
    t0 = time.perf_counter()
    kernels.build(names, verbose=True)
    for name in names:
        print(f"[probe] {name} ptxas: " + "; ".join(
            f"{k}: {v}" for k, v in kernels.ptxas_usage(kernels.BUILD_LOGS.get(name, "")).items()),
            flush=True)
    paths = build_variants(variants)
    print(f"[probe] built in {time.perf_counter() - t0:.1f} s", flush=True)
    libs = {}
    for k in only:
        name, tag, _, setters = probes[k]
        libs[tag] = load(paths[tag], name, setters)
        if parents[k] in paths:
            libs[parents[k]] = load(paths[parents[k]], name)
    if "s" in only:
        print("[probe] S resources: " + cs.kernel_resources(
            "splat_segments", {"S": "seg_composite_kernel", "S order": "seg_order_kernel"},
            {"S": 0, "S order": 0}), flush=True)
        probe_s(dev, libs)
    if "k1" in only:
        print("[probe] K1 resources: " + cs.kernel_resources(
            "splat_tiles", {"K1": "tile_composite_kernel"}, {"K1": 0}), flush=True)
        probe_k1(dev, libs)
    if "winograd" in only:
        probe_winograd(dev, libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
