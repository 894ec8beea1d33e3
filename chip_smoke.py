#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--parent DIR]

Phases (any failure exits non-zero):
  1. build   — compiles the seven CUDA sources from audio_motion_avatar_tpu_torch/csrc
               (one nvcc per source, in parallel) into build/kernels/, with
               ptxas's registers and spills (printed again beside A, K2,
               A-bwd and K9a / K9b);
  2. kernels — calls each kernel's wrapper at the serving path's shapes and
               holds it against its plain PyTorch version on the same inputs:
               S (segmented splat, 6 frames at 512^2, 30k gaussians): max|diff| <= 1e-5
               and a second launch bit for bit;
               Q (quad rows, (18, 256, 16, 16, 256) bf16): bit-exact;
               A (attention, (2, 8, 6304, 64), its q_tail and the PTv3
               masked patches (354, 4, 512, 64), bf16) against the fp32
               plain version: every |diff| <= 2^-7 |ref| + 2^-4 RMS(ref),
               a rule that must also reject a version dropping the ragged
               last key block (or, masked, ignoring the mask);
               K1 (tile splat, 1 + 8 views at 1024^2, 30k gaussians, K = 512,
               and one 1296x2304 stage-2 frame): max|diff| <= 1e-5 and a
               second launch bit for bit;
               A at the stage-1 shapes (the ViT's 24 x 4096^2 self-attention,
               the SMPL-X predictor's 80 queries and the fusion's 3152, each
               over themselves and across to the 4096 image tokens): the same
               rule;
               times each with CUDA events beside its plain version, its
               bound and (A) scaled_dot_product_attention as a yardstick;
               train kernels: K2 (tile splat backward; the stage-1 step's 1 +
               8 views at 1024^2 and one 1296x2304 frame, K = 512, a seeded
               output gradient) against its plain version at rtol 1e-4, atol
               1e-5 max|ref|, and a second launch bit for bit; A-bwd
               (attention backward) at every training
               shape (audio self-attention and its final_tail, fusion and
               predictor self and cross, the PTv3 masked patches) against
               the fp32 plain backward, dQ / dK / dV each under A's rule,
               which must reject a backward that drops the ragged last keys
               or ignores the mask; times beside the plain versions, the
               bounds and (A-bwd) scaled_dot_product_attention's backward;
               K9a (Winograd conv, the serving chunk's five conv shapes) and
               K9b (GroupNorm-fused, at 512^2 and 256^2), bf16, against their
               plain versions under ops/winograd.excess_error, a rule that
               must reject a kernel dropping the halo pair-row, rounding its
               input transform once or (K9b) leaving the padded border to the
               affine; timed beside the plain versions, the bounds and
               F.conv2d (for K9b the chain relu(a x + c), F.conv2d);
  2c. parent comparison (only with --parent DIR, DIR holding an earlier
               tree's audio_motion_avatar_tpu_torch/csrc, e.g. unpacked by git
               archive under build/) — that tree's S, A, K1, K2, A-bwd and
               K9a / K9b built into build/parent/ and timed, through this
               tree's wrappers, beside this tree's at every shape of their
               checks, in turns (earlier, this, this, earlier), each output
               held against the earlier one (S and K1 must be bit-identical);
  3. small   — a tiny fp32 rollout on the card against the same rollout on
               the CPU (plain versions): frames mean|diff| <= 1e-3; then the
               tiny config with 64-wide audio heads (kernel A) in bf16 on
               both: the card's distance from the CPU's bf16 run must stay
               within 3x the CPU's own bf16-vs-fp32 distance;
  4. rollout — the full-width bf16 serving rollout (AvatarConfig() with the
               serving profile, B=2, T_in=2, T_out=6, 512^2, 10475-vertex
               synthetic SMPL-X, seeded weights): one warm-up request, then 3
               requests through serve() with the sliding token window; checks
               finite, non-blank frames and that every kernel's launch count
               grew by exactly what the path implies; prints fps = 12 / rollout
               seconds and peak device memory;
  5. profile — one more request: each stage's time (audio rollout, SMPL-X
               decoder, renderer), then the whole request under
               torch.profiler: the device's busy share and the 15 kernels
               that take the most device time;
  4b. serve, Winograd + splash — phase 4 with upsampler_conv='winograd' (K9a)
               and audio_attn_impl='splash' (kernel A): the same checks and
               launch counts (16 K9a, 52 A a request), then its frames against
               phase 4's direct-conv rollout on the same inputs and weights:
               mean|diff| <= 1e-2, PSNR >= 40 dB; then profiled as in 5 (5b);
  6. small stage 1 — a tiny reconstruction (reference view + 3 novel views)
               on the card against the CPU: fp32 with the tiny heads (K1), the
               image tokens of the CPU's ViT fed to both (the ViT runs in bf16
               whatever the config says, and rounds differently on the two):
               frames mean|diff| <= 1e-3; then bf16 with 64-wide predictor and
               fusion heads (kernel A) held to 3x the CPU's own bf16-vs-fp32
               distance;
  7. reconstruct — the full-width bf16 stage-1 reconstruction (AvatarConfig()
               defaults: Sapiens-1B geometry, 1024^2, dense upsampler, tile
               splat; seeded weights), B = 1, one reference view and 8 novel
               views: one warm-up and 3 timed requests; ms per request, stage
               times, peak memory, launches of K1 and A against the count the
               config implies, finite and non-blank frames;
  7b. reconstruct, winograd_gn — phase 7 with upsampler_conv='winograd_gn'
               (K9b: GroupNorm fused into every dense conv), 1 warm-up and 2
               requests; launches as the config implies, frames against phase
               7's within 1e-2 / 40 dB;
  8. serve from a reference — the serving model with its stage-1 stack: the
               tokens of 2 streams' 2 reference frames (the stage-1 pass, render
               off), then one rollout request from them; frames checked as in 4.
  9. small train — a tiny train step of each stage (a batch of 2) on the card
               against the CPU (plain versions): fp32, loss within 1e-4 and gradients
               within 1e-3; then bf16 with 64-wide heads: every A-bwd and K2
               launch of the step held against its plain version on its own
               inputs, and the step against the CPU's bf16 step with the
               attention rounding where kernels A and A-bwd round, within 3x
               the largest CPU bf16-vs-fp32 distance over three draws of the
               input frames; launches as the config implies;
 10. train stage 1 — full width (AvatarConfig(), the frozen ViT one block deep, bf16, B = 1,
               1024^2, 8 test views, lr 5e-5, accumulate 4, clip 1.0): 1
               warm-up + 8 micro-steps (two updates); ms a micro-step, peak
               memory, finite losses, moved trainable parameters, a
               bit-identical ViT, the K1 / K2 / A / A-bwd launches the config
               implies (remat recompute included) and the frames K1
               composites; then (10c) its evaluation twice on the same
               inputs: the metrics and every module's and triplane segment
               op's output the same bits;
 11. train stage 2 — the serving widths with the default render form at
               1296x2304, B = 2, T_in = 2, T_out = 6, lr 1e-4, clip 1.0, both
               remat knobs: 1 warm-up + 2 steps through Stage2TrainLoop (3
               before phase 18 needed the time), one reusing the prediction
               cache; the same checks.
 10b. train stage 1, winograd_gn — phase 10 with upsampler_conv='winograd_gn',
               accumulate 1: 1 warm-up + 2 micro-steps; the same checks (K9b
               16 a micro-step, remat recompute included), ms and peak memory
               beside phase 10's.
 12a. small demo — `main2.main --mode demo` on config_tiny.yaml (rendered-body
               data, 2 chunks) from seeded weights saved by the port's
               CheckpointManager, on the card and on the CPU: frames within
               mean|diff| <= 1e-3, the card's S, Q and K1 (the dataset's
               rendered targets) launches as the path implies; a seeded
               Wav2Vec2-base window (12 x 768, fp32, TF32 off) on the card
               against the CPU within 1e-3 of max|ref|, and its ms;
 12. demo — `main2.main --mode demo` at full width: config_stage_2.yaml with
               the synthetic dataset at 512^2, 2 items (1 chunk, B = 2, 12
               frames; 2 chunks before phase 18 needed the time), bf16, `--checkpoint` of
               tamed seeded weights, `--audio` a 16 kHz tone, a seeded
               Wav2Vec2-base checkout, the synthetic body in the released
               layout (release_body, as phase 15; all written under
               build/demo/); checks 12 frames written and not blank, 12
               overlays drawn, finite losses, S / Q / A launches as
               the path implies (the stage-1 token pass included); prints the seconds of
               the build, data, stage-1 tokens, audio features, each chunk's
               rollout, losses, overlays and writing, the demo's and the
               rollouts' fps, peak memory and whether the mp4s were written.
 13a. small CLI — main.main --mode train, then --mode test from its checkpoint,
               on a THuman-layout fixture, and main2.main --mode train, then
               --mode test, on a TED-layout fixture (both written by the port,
               read through its PNG decoder and resize), config_tiny.yaml,
               fp32, on the card and with --device cpu, the card fed the CPU's
               ViT tokens: every logged loss and metric within 1e-4 relative;
               the card's K1 / K2 / A / A-bwd launches as the config implies;
 13. train CLI, stage 1 — main.main --mode train on config_stage_1.yaml (bf16)
               with the THuman reader on a fixture under build/cli/ (8 + 2
               subjects x 12 views at 1024^2) from phase 10's seeded weights:
               8 micro-steps (two updates), validation, the monitored
               checkpoint; then --mode test from it, equal to the fit's
               validation (within 1e-5 of max(|v|, 1e-3)); finite losses,
               moved parameters, a bit-identical ViT, the outputs, the
               launches; the ms of a
               micro-step beside phase 10's, the reader's host seconds, peak
               memory; and the host's seconds to decode a 1920 x 1080 PNG
               under each row filter and to resize it;
 14. train CLI, stage 2 — main2.main --mode train on config_stage_2.yaml (bf16)
               with the TED reader on a 22-frame clip at 1296 x 2304 from
               phase 11's seeded weights, B = 2: 2 steps (cut from 7 steps
               on 42 frames, and the frozen ViT cut to one block, to make
               room for phase 18); then --mode test
               from its checkpoint on the clip (4 items); the same checks,
               the cache depth of each step, the ms of a step beside phase
               11's.
 14b. train CLI, stage 2, workers — phase 14's fit with
               training.dataloader.num_workers=4 (the native prefetch ring,
               built by g++ into build/host/) on the same clip (2 steps):
               the ring that ran, every item handed on once, the launches;
               the wall a step beside phase 14's.
 15. import demo — `main2.main --mode demo --checkpoint FILE`: phase 12's demo
               at 1 chunk from a seeded Lightning .ckpt of the released
               stage-2 checkpoint's 649 tensor names and shapes
               (tests/fixtures/ted_full_ckpt.manifest.json) on the synthetic
               body with the released face count (build/import/): 0
               mismatches, the CPU dry run's loaded count and skipped
               modules, the upsampler norm 'affine', frames not blank, the
               launches; the import's seconds, the rollouts' fps, peak memory.
 16. train CLI, IDOL — main.main --mode train on config_stage_1_idol.yaml
               (bf16) with the IDOL reader on reference-layout caches at
               896 x 640 (build/cli/idol: 4 + 1 scenes x 12 views, 8 views an
               item): 4 micro-steps, validation, checkpoint, then --mode test
               equal to the validation as in 13; the ms of a micro-step beside
               phase 10's, the reader's seconds an item, launches, peak memory.
17a. small render forms — the forms the serving and default paths leave out,
               at the tiny profile, card against CPU on the same seeded
               weights: fp32 rollouts with SH colours (rgb False) of degree 1
               and 3 sampled by quad rows (Q), four taps, slabs, and four taps
               over the sparse penultimate level, and one without the
               upsampler (frames mean|diff| <= 1e-3); a stage-1 forward with
               the encoder's upsample path (TriplaneDownsampler) and SH
               colours (1e-3); one stage-1 train step with rgb False and one
               with the sparse upsampler's 4-tap sampler, each held as in 9;
 17. render forms — full width, bf16, the synthetic body: the serving model
               with SH colours of degree 3 (a 48-wide shs head), B = 2, T_in =
               2, T_out = 6, 512^2, 2 requests in each form (quad: Q then S;
               4-tap; slab; 4-tap with the sparse penultimate level) on the
               same tokens: launches, frames not blank, fps beside phase 4's;
               slab, quad and the penultimate form held to the 4-tap frames
               (mean|diff| <= 1e-2, 40 dB); a stage-1 model (SH degree 3,
               the encoder's upsample path: scatter at 96^2, downsampled to
               32^2; 1024^2, 8 test views): on its seeded weights the novel
               views not blank and one reconstruction request without the
               upsampler beside phase 7's; then 4 micro-steps holding one
               update beside phase 10's, launches, peak memory, finite
               losses, the update moving the downsampler, the shs head and
               the loss.
18a. small parallel — parallel/ on the one card, ranks as processes of this
               script (python3 chip_smoke.py --rank ...) joined by gloo with
               CUDA tensors, since NCCL refuses two ranks of one
               communicator on one card (a probe pair prints NCCL's answer):
               tiny bf16 train steps of both stages (64-wide heads: A and
               A-bwd on the local heads) over (2, 1) and (1, 2), each held
               to the one-process step on the card within 3x the CPU's bf16
               vs fp32 distance over three draws (phase 9's rule); launches
               as the local batch implies; main2 --mode train on
               config_tiny.yaml at world size 1 over NCCL (torchrun's
               variables, training.multihost=true).
 18. parallel — (a) main2 --mode train with training.devices=2 on phase
               14's clip (2 steps, B = 2 global, 1 a rank), two processes on
               the card started with torchrun's variables, --dist-backend
               gloo --device cuda:0: the first step held to phase 14's
               first step (the loss within 3x the distance between that
               batch's loss as one batch and as two rows, measured in 14,
               and within 1e-5 of the latter; grad_norm within 18a's
               stage-2 gradient bound), per rank
               ms a step, the gradient all-reduce's seconds, peak memory,
               launches, cache depth; one event file and one checkpoint;
               (b) one serving request at the serving width over (1, 2) on
               the same processes (phase 4's model, tokens and request):
               frames against phase 4's (mean|diff| <= 1e-2, the squared
               difference within 3x that of the request's streams served
               one at a time in one process), kernel A's launches and local
               heads a rank. Times are correctness context (two ranks share
               the card, gloo crosses the host).
Every full-width phase but the reconstruction (7, 7b), phase 17's stage-1
model and the kernel checks builds the frozen Sapiens ViT one block deep
(SHALLOW_VIT: its seeded init took ~15 s a build; the script's time limit). Each phase prints its seconds, and the
script its whole run's. Then one
{"kernels": [...]} line (nine kernels: splash is kernel A under the JAX
package's splash name; each kernel's launches those of its paths,
phases 15, 16, 17a, 17, 18a and 18 added, the ranks' counted in their own
processes), the card's name and power limit, and as the last
line {"ok": true, "device": {...}}. Takes about a quarter of an hour on one
H100, the kernels' build included.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor cores
PEAK_FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
# fp32 operations a (pixel, gaussian) pair of the splat walk (kernels S
# and K1) needs, by what the rule makes of it (walk_operations). Blended:
# dx, dy (2), power (9), exp and its scale by the opacity (2), 2 compares
# (the drop test), the 0.99 clamp (1), log1p + add (2), T's exp + the 1e-4
# compare (2), weight (1), 3 colour multiply-adds (6)
SPLAT_OPS_PER_PAIR = 27
SPLAT_OPS_FAR = 2 + 9 + 1           # power < -5.6 (opacity <= 1): dropped before its exp
SPLAT_OPS_DROPPED = 2 + 9 + 2 + 2   # dropped by the test
SPLAT_OPS_UNWEIGHTED = 15 + 1 + 2 + 1   # kept, T after it under 1e-4: no weight
# ... and of K2's function, counted as the gradient needs it and not as
# this kernel does it: one forward recompute (27: the clip mask and T_final
# need the whole blend) and one backward walk that evaluates each alpha once:
# dx, dy, power, exp, alpha (17), log1p + add (2), two exp + compare (3),
# weight (2), G (5), dalpha (6), suffix sum (2), gates (3), the nine
# per-slot values (17) and their nine sums (9). K2 itself also rebuilds each
# chunk's prefix (19 more), which the bound does not count.
SPLAT_BWD_OPS_PER_PAIR = 27 + 66


def upsampler_launches(cfg):
    """(K9a, K9b) launches of one dense upsampler pass (the default render
    form): two ResBlock convs a level, every level's shape taken by the
    kernels when the width is a multiple of 128; 'winograd_gn' with the
    group norm fuses all of them (K9b)."""
    n = 2 * cfg.num_upsample_blocks
    if cfg.upsampler_conv == "xla" or cfg.triplane_feature_dim % 128:
        return 0, 0
    if cfg.upsampler_conv == "winograd_gn" and cfg.upsampler_norm == "group":
        return 0, n
    return n, 0


def train_launches(cfg, stage, B, T_in, T_out):
    """Kernel launches one train micro-step implies, the remat recompute
    included: {attention, attention_bwd, composite_tiles,
    composite_tiles_bwd, winograd_conv3x3, winograd_conv3x3_gn_relu}.
    Stage 1: B x T_in reference frames rendered under autograd and T_out
    test views (one composite launch for all). Stage 2: the stage-1 pass
    over B x T_in reference frames without autograd (its render included),
    then the rollout of B x T_out frames. A 64-wide head runs kernel A; the
    ViT's always without autograd. Each frame chunk rendered is one
    upsampler pass (the Winograd convs' backward is the direct conv's)."""
    def wide(head_dim):
        return head_dim == 64

    vit = cfg.vit_depth if wide(cfg.image_feature_dim // cfg.vit_heads) else 0
    pred = 2 * cfg.smplx_transformer_layers if wide(cfg.smplx_transformer_head_dim) else 0
    fus = 2 * cfg.cross_transformer_layers if wide(cfg.cross_transformer_head_dim) else 0
    dec0 = cfg.ptv3_dec_depths[0] if not cfg.no_point_refiner and \
        wide(cfg.ptv3_dec_channels[0] // cfg.ptv3_dec_heads[0]) else 0
    remat_f = 2 if cfg.frames_scan_remat else 1

    def chunks(frames):
        F = cfg.frames_per_chunk
        return frames // F if F > 0 and frames % F == 0 else frames

    k9a, k9b = upsampler_launches(cfg)
    if stage == 1:
        ref = chunks(B * T_in)
        return {"attention": vit + pred + fus + dec0 * ref * remat_f,
                "attention_bwd": pred + fus + dec0 * ref,
                "composite_tiles": ref * remat_f + 1,
                "composite_tiles_bwd": ref + 1,
                "winograd_conv3x3": k9a * ref * remat_f,
                "winograd_conv3x3_gn_relu": k9b * ref * remat_f}
    audio = cfg.audio_transformer_layers * T_out if wide(cfg.audio_transformer_head_dim) else 0
    remat_a = 2 if cfg.audio_transformer_remat else 1
    ref, out = chunks(B * T_in), chunks(B * T_out)
    return {"attention": vit + pred + fus + dec0 * ref + audio * remat_a + dec0 * out * remat_f,
            "attention_bwd": audio + dec0 * out,
            "composite_tiles": ref + out * remat_f,
            "composite_tiles_bwd": out,
            "winograd_conv3x3": k9a * (ref + out * remat_f),
            "winograd_conv3x3_gn_relu": k9b * (ref + out * remat_f)}


def time_ms(fn, iters, warmup=1):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches=20, replays=10):
    """Device time of one call of fn: `launches` calls captured in a CUDA
    graph, replayed `replays` times between CUDA events. Where a call's host
    work takes longer than its kernels, time_ms measures the host; this
    does not."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(launches):
                fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (launches * replays)


def bound(flops, peak_flops, nbytes):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_resources(name, entries, smem):
    """One line per kernel entry of library `name` whose mangled name holds
    one of `entries` (label -> substring): registers and spills from this
    run's ptxas log (kernels.build(verbose=True)), and its dynamic shared
    memory (`smem`: label -> bytes)."""
    from audio_motion_avatar_tpu_torch import kernels
    usage = kernels.ptxas_usage(kernels.BUILD_LOGS.get(name, ""))
    out = []
    for label, key in entries.items():
        u = next((v for k, v in usage.items() if key in k), None)
        regs = "not in this run's build log" if u is None else (
            f"{u.get('registers')} registers, {u.get('spill_stores')} bytes spill stores, "
            f"{u.get('spill_loads')} bytes spill loads, {u.get('smem', 0)} bytes static "
            "shared memory")
        out.append(f"{label}: {regs}, {smem[label]} bytes dynamic shared memory")
    return "; ".join(out)


def segment_inputs(dev):
    """Kernel S's serving inputs: 6 frames at 512^2 of 30k gaussians,
    sorted into (tile, depth) segments -> (args of composite_segments, N,
    frames, tiles a frame)."""
    import numpy as np
    import torch
    from audio_motion_avatar_tpu_torch.ops import splat_segmented as ss
    from audio_motion_avatar_tpu_torch.ops.cameras import make_camera
    from audio_motion_avatar_tpu_torch.ops.splat import (
        activate_opacity, activate_scales, project_gaussians)

    N, W, H, F = 30000, 512, 512, 6
    rng = np.random.RandomState(0)
    xyz = (rng.randn(N, 3) * np.array([0.25, 0.6, 0.15])).astype(np.float32)
    rot = rng.randn(N, 4).astype(np.float32)
    rot[:, 0] += 3.0
    raw_s = rng.randn(N, 3).astype(np.float32) * 0.3
    raw_o = rng.randn(N).astype(np.float32)
    col = rng.rand(N, 3).astype(np.float32)
    K = np.array([[600.0, 0, W / 2], [0, 600.0, H / 2], [0, 0, 1]], np.float32)
    E = np.eye(4, dtype=np.float32)
    E[2, 3] = 2.5

    def t(a):
        return torch.as_tensor(a, device=dev)

    xyz_f = torch.stack([t(xyz) + 1e-4 * f for f in range(F)])
    cam = make_camera(t(np.stack([K] * F)), t(np.stack([E] * F)), W, H)
    proj = project_gaussians(
        xyz_f, t(rot).expand(F, N, 4), activate_scales(t(raw_s)).expand(F, N, 3),
        activate_opacity(t(raw_o)).expand(F, N), t(col).expand(F, N, 3), cam)
    params, starts, counts = ss.pack_sorted_params(proj, W, H, 512, 4,
                                                   large_cap=2048)
    tx = W // 16
    return (params, starts, counts, tx, tx * (H // 16)), N, F, tx * (H // 16)


def check_splat(dev):
    import torch
    from audio_motion_avatar_tpu_torch.ops import splat_segmented as ss

    print("[kernels] S resources: " + kernel_resources(
        "splat_segments", {"S": "seg_composite_kernel", "S order": "seg_order_kernel"},
        {"S": 0, "S order": 0}), flush=True)
    args, N, F, tpf = segment_inputs(dev)
    params, starts, counts = args[:3]
    out_k = ss.composite_segments(*args)
    again = ss.composite_segments(*args)
    out_p = ss.composite_segments_plain(*args)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    print(f"[kernels] S splat_segments: tiles={starts.shape[0]} "
          f"segment entries={int(counts.sum())} max|diff|={err:.3e} (tol 1e-5); a second "
          f"launch bit-identical: {torch.equal(out_k, again)}", flush=True)
    if not err <= 1e-5:
        raise AssertionError(f"kernel S disagrees with its plain version: {err}")
    if not torch.equal(out_k, again):
        raise AssertionError("kernel S differs between two launches")
    bound_ms, by, classes, every_ms, old_ms = segments_bound(*args)
    print(f"[kernels] S bound {bound_ms:.4f} ms ({by}: {classes}; 36 bytes a segment entry, "
          f"starts and counts at 4 bytes, the output); at 27 operations every pair "
          f"{every_ms:.4f} ms, and with all of params and starts at 8 bytes {old_ms:.4f} ms",
          flush=True)
    return {"name": "splat_segments", "err": err,
            "ms": time_ms(lambda: ss.composite_segments(*args), 20),
            "plain_ms": time_ms(lambda: ss.composite_segments_plain(*args), 2),
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
            "shape": f"{F} frames x {tpf} tiles, {N} gaussians"}


def check_quad(dev):
    import torch
    from audio_motion_avatar_tpu_torch.models.upsampler import select_tiles
    from audio_motion_avatar_tpu_torch.ops import triplane as tp

    FP, cap, T, C, grid = 18, 256, 16, 256, 32
    g = torch.Generator(device=dev).manual_seed(0)
    uv = torch.randn(FP, 30000, 2, device=dev, generator=g) * \
        torch.tensor([0.2, 0.5], device=dev)
    _, _, slot, _ = select_tiles(uv, grid, cap, T)
    tiles = torch.randn(FP, cap, T, T, C, device=dev, generator=g).to(torch.bfloat16)
    out_k = tp.quad_rows(tiles, slot, grid)
    out_p = tp.quad_rows_plain(tiles, slot, grid)
    torch.cuda.synchronize()
    exact = torch.equal(out_k.view(torch.int16), out_p.view(torch.int16))
    err = float((out_k.float() - out_p.float()).abs().max())
    covered = int((slot >= 0).sum())
    print(f"[kernels] Q quad_rows: {tuple(tiles.shape)} bf16, {covered} covered "
          f"tiles, bit-exact={exact} max|diff|={err}", flush=True)
    if not exact:
        raise AssertionError("kernel Q is not bit-exact against its plain version")
    nbytes = 5 * tiles.numel() * tiles.element_size()
    bound_ms, by = bound(0.0, PEAK_BF16_FLOPS, nbytes)
    return {"name": "quad_rows", "err": err,
            "ms": time_ms(lambda: tp.quad_rows(tiles, slot, grid), 20),
            "plain_ms": time_ms(lambda: tp.quad_rows_plain(tiles, slot, grid), 5),
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
            "shape": f"{tuple(tiles.shape)} bf16"}


def check_attention(dev):
    import torch
    import torch.nn.functional as Fn
    from audio_motion_avatar_tpu_torch import kernels
    from audio_motion_avatar_tpu_torch.ops import attention as at

    lib = kernels.library("attention")
    print("[kernels] A resources: " + kernel_resources(
        "attention", {"2 warpgroups": "attn_fwd_kernelILi2E", "3 warpgroups": "attn_fwd_kernelILi3E"},
        {"2 warpgroups": lib.attention_smem(2), "3 warpgroups": lib.attention_smem(3)}), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=g).to(torch.bfloat16)

    # audio self-attention (S = 2 (3 32^2 + 80) = 6304, not a multiple of
    # the 64-key block), and its last layer's q_tail = 3152 queries
    B, H, S, D = 2, 8, 6304, 64
    q, k, v = rnd(B, H, S, D), rnd(B, H, S, D), rnd(B, H, S, D)
    cases = [("audio", q, k, v, None), ("audio q_tail", q[:, :, -3152:].contiguous(), k, v, None)]
    # PTv3 dec0 patch attention: 6 clouds x 59 patches of 512, 4 heads,
    # valid-first key mask (30000 of 30208 points valid)
    G, Hp, P = 6 * 59, 4, 512
    mask = torch.ones(G, P, dtype=torch.bool, device=dev)
    mask[58::59, 30000 - 58 * 512:] = False
    qp, kp, vp = rnd(G, Hp, P, D), rnd(G, Hp, P, D), rnd(G, Hp, P, D)
    cases.append(("ptv3 masked", qp, kp, vp, mask))
    scale = D ** -0.5
    errs = []
    for name, q_, k_, v_, m_ in cases:
        out_k = at.attention(q_, k_, v_, scale, m_)
        ref = at.attention_plain(q_.float(), k_.float(), v_.float(), scale, m_)
        # the same rule on a version that is wrong where it matters: one
        # that drops the ragged last key block (6304 = 98 * 64 + 32), or
        # one that ignores the key mask; it must be rejected
        if m_ is None:
            n = S - S % 64
            wrong = at.attention_plain(q_, k_[:, :, :n], v_[:, :, :n], scale)
            wrong_name = f"drops the last {S - n} keys"
        else:
            wrong = at.attention_plain(q_, k_, v_, scale)
            wrong_name = "ignores the mask"
        torch.cuda.synchronize()
        err = float((out_k.float() - ref).abs().max())
        excess, wrong_excess = at.excess_error(out_k, ref), at.excess_error(wrong, ref)
        errs.append(err)
        print(f"[kernels] A attention {name}: q {tuple(q_.shape)} kv "
              f"{tuple(k_.shape)} max|diff|={err:.3e} against the fp32 plain "
              f"version, reference RMS {float(ref.pow(2).mean().sqrt()):.3e}; "
              f"excess {excess:.3f} (tol 1: |diff| <= 2^-7 |ref| + 2^-4 RMS); "
              f"a version that {wrong_name}: excess {wrong_excess:.3f}",
              flush=True)
        if not excess <= 1.0:
            raise AssertionError(f"kernel A disagrees on {name}: excess {excess}")
        if not wrong_excess > 1.0:
            raise AssertionError(f"the tolerance on {name} does not reject a "
                                 f"version that {wrong_name}")
        if name == "ptv3 masked":
            ms = time_ms(lambda: at.attention(q_, k_, v_, scale, m_), 10)
            fl = 4.0 * G * Hp * P * P * D
            print(f"[kernels] A attention ptv3 masked: {ms:.4f} ms "
                  f"({fl / ms / 1e9:.1f} TFLOP/s)", flush=True)
    flops = 4.0 * B * H * S * S * D
    nbytes = 4 * q.numel() * q.element_size()
    bound_ms, by = bound(flops, PEAK_BF16_FLOPS, nbytes)
    ms = time_ms(lambda: at.attention(q, k, v, scale), 10)
    print(f"[kernels] A attention audio: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)",
          flush=True)
    return {"name": "attention", "err": max(errs), "ms": ms,
            "plain_ms": time_ms(lambda: at.attention_plain(q, k, v, scale), 2),
            "bound_ms": bound_ms, "bound_by": by,
            "library_ms": time_ms(lambda: Fn.scaled_dot_product_attention(q, k, v), 10),
            "shape": f"({B}, {H}, {S}, {D}) bf16"}


def stage1_attention_shapes():
    """Kernel A's stage-1 shapes, (name, H, Sq, Skv) at B = 1: the ViT's
    self-attention, the SMPL-X predictor's and the fusion's, each over
    themselves and across to the image tokens."""
    from audio_motion_avatar_tpu_torch.models.config import AvatarConfig

    cfg = AvatarConfig()
    S_img = (cfg.sapiens_resolution // cfg.vit_patch) ** 2
    L = cfg.smpl_token_len
    S_fus = 3 * cfg.triplane_resolution ** 2 + L
    Hv, Hp, Hf = cfg.vit_heads, cfg.smplx_transformer_num_heads, cfg.cross_transformer_num_heads
    return [("vit self", Hv, S_img, S_img), ("predictor self", Hp, L, L),
            ("predictor cross", Hp, L, S_img), ("fusion self", Hf, S_fus, S_fus),
            ("fusion cross", Hf, S_fus, S_img)]


def check_attention_stage1(dev):
    """Kernel A at the stage-1 shapes under the same rule as the serving
    shapes; returns {shape name: ms} of the kernel."""
    import torch
    from audio_motion_avatar_tpu_torch.ops import attention as at

    g = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=g).to(torch.bfloat16)

    times = {}
    for name, H, Sq, Skv in stage1_attention_shapes():
        q, k, v = rnd(1, H, Sq, 64), rnd(1, H, Skv, 64), rnd(1, H, Skv, 64)
        out = at.attention(q, k, v, 0.125)
        ref = at.attention_plain(q.float(), k.float(), v.float(), 0.125)
        torch.cuda.synchronize()
        excess = at.excess_error(out, ref)
        times[name] = time_ms(lambda: at.attention(q, k, v, 0.125), 10)
        fl = 4.0 * H * Sq * Skv * 64
        print(f"[kernels] A attention stage-1 {name}: q (1, {H}, {Sq}, 64) kv "
              f"(1, {H}, {Skv}, 64) excess {excess:.3f} (tol 1), "
              f"{times[name]:.4f} ms ({fl / times[name] / 1e9:.1f} TFLOP/s)", flush=True)
        if not excess <= 1.0:
            raise AssertionError(f"kernel A disagrees at the stage-1 shape {name}: "
                                 f"excess {excess}")
    return times


def walk_operations(slot, n_slots, n_tiles, tx, tiles_per_frame, device):
    """The fp32 operations that the splat walk's rule needs on these inputs:
    each tile's slots followed in order, as the plain version
    (ops/splat.py blend_tiles_plain) follows them, and every (pixel, slot)
    pair of a slot that holds a gaussian counted by its class: far
    (SPLAT_OPS_FAR), dropped otherwise (SPLAT_OPS_DROPPED), kept with T
    after it under 1e-4 (SPLAT_OPS_UNWEIGHTED) or blended
    (SPLAT_OPS_PER_PAIR). slot(j) -> ((9, T) params of slot j of every
    tile, opacity 0 where a tile has none; (T,) bool, the tiles that hold
    one). Returns (operations, {class: pairs})."""
    import torch
    from audio_motion_avatar_tpu_torch.ops import splat as sp

    px, py = sp.tile_pixels(n_tiles, tx, tiles_per_frame, device)
    logT = torch.zeros(n_tiles, 256, device=device)
    n = torch.zeros(4, dtype=torch.int64, device=device)
    for j in range(n_slots):
        g, held = slot(j)
        power, alpha, keep = (sp.slot_alpha(g, px, py)[i] for i in (2, 5, 6))
        held = held[:, None]
        far = (power < -5.6) & (g[5] <= 1.0)[:, None] & held
        kept = keep & held
        logT = logT + torch.log1p(-alpha)   # alpha 0 where dropped: log T unchanged
        weighted = kept & ~(torch.exp(logT) < sp.T_EPS)
        n += torch.stack([far.sum(), (held & ~far & ~keep).sum(), (kept & ~weighted).sum(),
                          weighted.sum()])
    pairs = dict(zip(("far", "dropped", "unweighted", "blended"), n.tolist()))
    ops = (SPLAT_OPS_FAR * pairs["far"] + SPLAT_OPS_DROPPED * pairs["dropped"]
           + SPLAT_OPS_UNWEIGHTED * pairs["unweighted"] + SPLAT_OPS_PER_PAIR * pairs["blended"])
    return ops, pairs


def pair_classes(ops, pairs):
    total = sum(pairs.values())
    return (f"{ops / total:.2f} operations a pair on average: of {total} pairs "
            + ", ".join(f"{k} {v / total:.4f}" for k, v in pairs.items()))


def segments_bound(params, starts, counts, tx, tiles_per_frame):
    """S's bound on these inputs, as the function's work: the operations
    that its pairs need (walk_operations) against the bytes it must move,
    the 9 floats of every segment entry, starts and counts at 4 bytes a
    tile and the (T, 256, 3) output. Returns that bound, what bounds it, the
    pair classes and, for comparison, the bound at 27 operations every
    pair and that with the bytes counted before (all of params, every
    emitted entry, and starts at 8 bytes)."""
    import torch
    s64, c64 = starts.long(), counts.long()

    def slot(j):
        held = j < c64
        g = params[:, torch.where(held, s64 + j, 0)].clone()
        g[5] = torch.where(held, g[5], torch.zeros_like(g[5]))
        return g, held

    ops, pairs = walk_operations(slot, int(counts.max()), starts.numel(), tx,
                                 tiles_per_frame, params.device)
    entries = int(counts.sum())
    out_bytes = starts.numel() * 256 * 3 * 4
    nbytes = entries * 9 * 4 + (starts.numel() + counts.numel()) * 4 + out_bytes
    bound_ms, by = bound(ops, PEAK_FP32_FLOPS, nbytes)
    every_ms, _ = bound(SPLAT_OPS_PER_PAIR * entries * 256, PEAK_FP32_FLOPS, nbytes)
    old_ms, _ = bound(SPLAT_OPS_PER_PAIR * entries * 256, PEAK_FP32_FLOPS,
                      params.numel() * 4 + starts.numel() * 8 + out_bytes)
    return bound_ms, by, pair_classes(ops, pairs), every_ms, old_ms


def packed_views(dev, W, H, windows, K=512, N=30000):
    """30k body-like gaussians seen by len(windows) orbiting views at W x H,
    binned and packed per view (K = max_per_tile slots, each view's binning
    window), stacked as the renderer's one launch takes them: (packed
    (F * T, 9, K), tx, T, valid (tile, slot) entries)."""
    import numpy as np
    import torch
    from audio_motion_avatar_tpu_torch.ops import splat_tiles as st
    from audio_motion_avatar_tpu_torch.ops.cameras import make_camera, orbit_cameras
    from audio_motion_avatar_tpu_torch.ops.splat import (
        Projected, activate_opacity, activate_scales, bin_gaussians_sorted,
        project_gaussians)

    F = len(windows)
    rng = np.random.RandomState(0)
    xyz = (rng.randn(N, 3) * np.array([0.25, 0.6, 0.15])).astype(np.float32)
    rot = rng.randn(N, 4).astype(np.float32)
    rot[:, 0] += 3.0
    raw_s = rng.randn(N, 3).astype(np.float32) * 0.3 - 1.0
    raw_o = rng.randn(N).astype(np.float32)
    col = rng.rand(N, 3).astype(np.float32)
    cams = orbit_cameras(1, F, (H, W))

    def t(a):
        return torch.as_tensor(a, device=dev)

    cam = make_camera(t(cams["intrinsic"][0]), t(cams["extrinsic"][0]), W, H)
    proj = project_gaussians(
        t(xyz).expand(F, N, 3), t(rot).expand(F, N, 4),
        activate_scales(t(raw_s)).expand(F, N, 3),
        activate_opacity(t(raw_o)).expand(F, N), t(col).expand(F, N, 3), cam)
    views = [Projected(*(a[f] for a in proj)) for f in range(F)]
    packed = torch.cat([st.pack_tile_params(v, W, H, K, w) for v, w in zip(views, windows)])
    valid = sum(int(bin_gaussians_sorted(v, W, H, K, max_window=w)[2].sum())
                for v, w in zip(views, windows))
    return packed, W // 16, (W // 16) * (H // 16), valid


def check_tiles(dev):
    """K1 at the reconstruction's shapes: 30k body-like gaussians seen by 1
    reference and 8 novel orbiting views at 1024^2, binned and packed per
    view (K = max_per_tile = 512, window 4 for the reference and 8 for the
    novel views, as the renderer and render_multi_view bin them), all views
    in one launch, and at one 1296x2304 stage-2 frame: held against the plain
    version and a second launch (bit for bit), timed beside the bound."""
    import torch
    from audio_motion_avatar_tpu_torch.ops import splat_tiles as st

    print("[kernels] K1 resources: " + kernel_resources(
        "splat_tiles", {"K1": "tile_composite_kernel"}, {"K1": 0}), flush=True)

    N, W, H, F, K = 30000, 1024, 1024, 9, 512
    packed, tx, T, valid = packed_views(dev, W, H, [4] + [8] * (F - 1), K, N)
    out_k = st.composite_tiles(packed, tx, T)
    again = st.composite_tiles(packed, tx, T)
    out_p = st.composite_tiles_plain(packed, tx, T)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    padded = packed.shape[0] * K
    print(f"[kernels] K1 splat_tiles: {F} views x {T} tiles, K={K}, {N} gaussians: "
          f"valid (tile, slot) entries {valid} of {padded} padded; "
          f"max|diff|={err:.3e} (tol 1e-5); non-white share "
          f"{float((out_k < 0.999).float().mean()):.4f}; a second launch bit-identical: "
          f"{torch.equal(out_k, again)}", flush=True)
    if not err <= 1e-5:
        raise AssertionError(f"kernel K1 disagrees with its plain version: {err}")
    if not torch.equal(out_k, again):
        raise AssertionError("kernel K1 differs between two launches")
    del again
    ms, bound_ms, by = time_tiles(packed, tx, T, valid, f"{F} views")
    line = {"name": "splat_tiles", "err": err, "ms": ms,
            "plain_ms": time_ms(lambda: st.composite_tiles_plain(packed, tx, T), 1),
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
            "shape": f"({F * T}, 9, {K}) fp32, {valid} valid entries"}
    del packed, out_k, out_p
    # the stage-2 training frame (28 launches a step, of 1 to 4 frames)
    packed, tx, T, valid = packed_views(dev, 2304, 1296, [4], K, N)
    out_k = st.composite_tiles(packed, tx, T)
    again = st.composite_tiles(packed, tx, T)
    err = float((out_k - st.composite_tiles_plain(packed, tx, T)).abs().max())
    print(f"[kernels] K1 splat_tiles one 1296x2304 frame: {tuple(packed.shape)}, {valid} valid "
          f"entries; max|diff|={err:.3e} (tol 1e-5); a second launch bit-identical: "
          f"{torch.equal(out_k, again)}", flush=True)
    if not err <= 1e-5:
        raise AssertionError(f"kernel K1 disagrees with its plain version at the frame: {err}")
    if not torch.equal(out_k, again):
        raise AssertionError("kernel K1 differs between two launches at the frame")
    time_tiles(packed, tx, T, valid, "one 1296x2304 frame")
    del packed, out_k, again
    torch.cuda.empty_cache()
    return line


def tiles_bound(packed, valid, tx, tiles_per_frame):
    """K1's bound on packed (T, 9, K) with `valid` live (tile, slot)
    entries, as the function's work: the operations that its live pairs
    need (walk_operations) against the bytes it must move, the opacity row
    of every slot, the 8 other floats of each live slot and the (T, 256, 3)
    output. Returns that bound, what bounds it, the pair classes and, for
    comparison, the bound at 27 operations every live pair."""
    T, _, K = packed.shape
    live = packed[:, 5] != 0
    n_slots = int(live.any(0).nonzero().max()) + 1 if bool(live.any()) else 0
    ops, pairs = walk_operations(lambda j: (packed[:, :, j].T, live[:, j]), n_slots, T, tx,
                                 tiles_per_frame, packed.device)
    if sum(pairs.values()) != valid * 256:
        raise AssertionError(f"K1's bound: {sum(pairs.values())} pairs of nonzero opacity, "
                             f"{valid} valid entries")
    nbytes = T * K * 4 + valid * 8 * 4 + T * 256 * 3 * 4
    bound_ms, by = bound(ops, PEAK_FP32_FLOPS, nbytes)
    every_ms, _ = bound(SPLAT_OPS_PER_PAIR * valid * 256, PEAK_FP32_FLOPS, nbytes)
    return bound_ms, by, pair_classes(ops, pairs), every_ms


def time_tiles(packed, tx, T, valid, name):
    """K1's CUDA-event time on packed, printed beside its bound."""
    from audio_motion_avatar_tpu_torch.ops import splat_tiles as st
    bound_ms, by, classes, every_ms = tiles_bound(packed, valid, tx, T)
    ms = time_ms(lambda: st.composite_tiles(packed, tx, T), 10)
    print(f"[kernels] K1 splat_tiles {name}: {ms:.4f} ms, bound {bound_ms:.4f} ms ({by}: "
          f"{classes}; the opacity rows, the live slots' other floats and the output); at 27 "
          f"operations every live pair {every_ms:.4f} ms", flush=True)
    return ms, bound_ms, by


def bwd_close(got, ref):
    """K2's rule against its plain version: rtol 1e-4 (the JAX package's
    own for its backward kernel) and atol 1e-5 of the largest |ref| (the
    per-slot sums over a tile's 256 pixels are added in another order).
    Returns the worst ratio of |diff| to that tolerance (1 or less agrees)."""
    import torch
    tol = 1e-4 * ref.abs() + 1e-5 * float(ref.abs().max()) + torch.finfo(torch.float32).tiny
    return float(((got - ref).abs() / tol).max())


# K2's training shapes (name, W, H, binning windows of the views): the
# stage-1 step's 1 reference and 8 test views at 1024^2, one stage-2 frame
K2_CASES = (("1 + 8 views at 1024^2", 1024, 1024, [4] + [8] * 8),
            ("one 1296x2304 frame", 2304, 1296, [4]))


def check_tiles_bwd(dev):
    """K2 at the training shapes (K2_CASES, K = 512), each in one launch,
    with a seeded output gradient; held against its plain version and
    against a second launch of its own (bit for bit), timed beside the
    plain version."""
    import torch
    from audio_motion_avatar_tpu_torch import kernels
    from audio_motion_avatar_tpu_torch.ops import splat_tiles as st

    lib = kernels.library("splat_tiles_bwd")
    print("[train kernels] K2 resources: " + kernel_resources(
        "splat_tiles_bwd", {"K2": "tile_bwd_kernel"}, {"K2": lib.splat_tiles_bwd_smem(512)}),
        flush=True)
    out = None
    for name, W, H, windows in K2_CASES:
        packed, tx, T, valid = packed_views(dev, W, H, windows)
        g = torch.randn(packed.shape[0], st.P, 3, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
        got = st.composite_tiles_bwd(packed, g, tx, T)
        again = st.composite_tiles_bwd(packed, g, tx, T)
        ref = st.composite_tiles_bwd_plain(packed, g, tx, T)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        excess = bwd_close(got, ref)
        identical = torch.equal(got, again)
        ms = time_ms(lambda: st.composite_tiles_bwd(packed, g, tx, T), 5)
        plain_ms = time_ms(lambda: st.composite_tiles_bwd_plain(packed, g, tx, T), 1, warmup=0)
        nbytes = 2 * packed.numel() * 4 + g.numel() * 4
        bound_ms, by = bound(SPLAT_BWD_OPS_PER_PAIR * valid * st.P, PEAK_FP32_FLOPS, nbytes)
        ops_ms = SPLAT_BWD_OPS_PER_PAIR * valid * st.P / PEAK_FP32_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        print(f"[train kernels] K2 splat_tiles_bwd {name}: {tuple(packed.shape)}, {valid} "
              f"valid entries; max|diff|={err:.3e}, max|ref|={float(ref.abs().max()):.3e}, "
              f"excess {excess:.3f} (tol 1: rtol 1e-4, atol 1e-5 max|ref|); {ms:.3f} ms, "
              f"plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({by}; operations "
              f"{ops_ms:.4f} ms at {SPLAT_BWD_OPS_PER_PAIR} a valid pair, bytes "
              f"{bytes_ms:.4f} ms); a second launch bit-identical: {identical}", flush=True)
        if not (excess <= 1.0 and torch.isfinite(got).all()):
            raise AssertionError(f"kernel K2 disagrees with its plain version on {name}")
        if not identical:
            raise AssertionError(f"kernel K2 differs between two launches on {name}")
        if out is None:
            out = {"name": "splat_tiles_bwd", "err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
                   "shape": f"({packed.shape[0]}, 9, 512) fp32, {valid} valid entries"}
        del packed, g, got, again, ref
        torch.cuda.empty_cache()
    return out


def attention_bwd_cases(dev):
    """A-bwd's training shapes, (name, B, H, Sq, Skv, kv_mask): the audio
    self-attention and its final_tail, fusion and predictor self and cross,
    the PTv3 decoder's masked patches (30000 points in patches of 512: 59
    patches, the last with 304 valid)."""
    import torch
    from audio_motion_avatar_tpu_torch.models.config import AvatarConfig

    cfg = AvatarConfig()
    S_img = (cfg.sapiens_resolution // cfg.vit_patch) ** 2
    L = cfg.smpl_token_len
    S_tri = 3 * cfg.triplane_resolution ** 2
    S_aud, S_fus = 2 * (S_tri + L), S_tri + L
    G, P = 59, cfg.ptv3_patch_size
    mask = torch.ones(G, P, dtype=torch.bool, device=dev)
    mask[-1, 30000 - (G - 1) * P:] = False
    return [("audio self", 2, 8, S_aud, S_aud, None),
            ("audio final_tail", 2, 8, S_aud // 2, S_aud, None),
            ("fusion self", 1, 8, S_fus, S_fus, None),
            ("fusion cross", 1, 8, S_fus, S_img, None),
            ("predictor self", 1, 8, L, L, None),
            ("predictor cross", 1, 8, L, S_img, None),
            ("ptv3 masked", G, 4, P, P, mask)]


def check_attention_bwd(dev):
    """A-bwd at every training shape against the fp32 plain backward on the
    same bf16 inputs: dQ, dK and dV each under ops/attention.excess_error's
    rule, which must also reject a backward that drops the ragged last keys
    and one that ignores the key mask. Times the audio self-attention
    beside its plain version, its bound and scaled_dot_product_attention's
    backward."""
    import torch
    import torch.nn.functional as Fn
    from audio_motion_avatar_tpu_torch import kernels
    from audio_motion_avatar_tpu_torch.ops import attention as at

    g = torch.Generator(device=dev).manual_seed(2)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=g).to(torch.bfloat16)

    cases = attention_bwd_cases(dev)
    scale = 64 ** -0.5
    bwd_lib = kernels.library("attention_bwd")
    print("[train kernels] A-bwd resources: " + kernel_resources(
        "attention_bwd", {"dK/dV and dQ blocks": "attn_bwd_main", "row statistics":
                          "attn_bwd_rows"},
        {"dK/dV and dQ blocks": bwd_lib.attention_bwd_smem(), "row statistics": 0}),
        flush=True)
    line, errs = None, []
    for name, B, H, Sq, Skv, m in cases:
        q, k, v, dout = rnd(B, H, Sq, 64), rnd(B, H, Skv, 64), rnd(B, H, Skv, 64), rnd(B, H, Sq, 64)
        out, stats = at._attention_kernel(q, k, v, scale, m, True)
        got = at.attention_bwd(q, k, v, scale, m, out, stats, dout)
        f32 = [t.float() for t in (q, k, v)]
        ref = at.attention_bwd_plain(*f32, scale, m, dout.float())
        torch.cuda.synchronize()
        excess = max(at.excess_error(a, b) for a, b in zip(got, ref))
        errs.append(max(float((a.float() - b).abs().max()) for a, b in zip(got, ref)))
        if m is None:
            n = Skv - Skv % 64 if Skv % 64 else Skv - 64
            wrong = at.attention_bwd_plain(f32[0], f32[1][:, :, :n], f32[2][:, :, :n], scale,
                                           None, dout.float())
            pad = Skv - n
            wrong = (wrong[0], Fn.pad(wrong[1], (0, 0, 0, pad)), Fn.pad(wrong[2], (0, 0, 0, pad)))
            wrong_name = f"drops the last {pad} keys"
        else:
            wrong = at.attention_bwd_plain(*f32, scale, None, dout.float())
            wrong_name = "ignores the mask"
        wrong_excess = max(at.excess_error(a, b) for a, b in zip(wrong, ref))
        ms = time_ms(lambda: at.attention_bwd(q, k, v, scale, m, out, stats, dout), 5)
        flops = 10.0 * B * H * Sq * Skv * 64
        print(f"[train kernels] A-bwd {name}: q ({B}, {H}, {Sq}, 64) kv ({B}, {H}, {Skv}, 64) "
              f"excess {excess:.3f} over dQ/dK/dV (tol 1); a backward that {wrong_name}: "
              f"excess {wrong_excess:.3f}; {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)",
              flush=True)
        if not excess <= 1.0:
            raise AssertionError(f"kernel A-bwd disagrees on {name}: excess {excess}")
        if not wrong_excess > 1.0:
            raise AssertionError(f"the rule on {name} does not reject a backward that "
                                 f"{wrong_name}")
        if name == "audio self":
            nbytes = 8 * q.numel() * 2 + stats.numel() * 4
            bound_ms, by = bound(flops, PEAK_BF16_FLOPS, nbytes)
            qa, ka, va = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
            o = Fn.scaled_dot_product_attention(qa, ka, va)
            lib = time_ms(lambda: torch.autograd.grad(o, (qa, ka, va), dout,
                                                      retain_graph=True), 5)
            line = {"name": "attention_bwd", "ms": ms,
                    "plain_ms": time_ms(lambda: at.attention_bwd_plain(
                        *f32, scale, None, dout.float()), 1, warmup=0),
                    "bound_ms": bound_ms, "bound_by": by, "library_ms": lib,
                    "shape": f"({B}, {H}, {Sq}, 64) bf16"}
            print(f"[train kernels] A-bwd audio self: bound {bound_ms:.4f} ms ({by}), plain "
                  f"{line['plain_ms']:.2f} ms, scaled_dot_product_attention backward "
                  f"{lib:.4f} ms", flush=True)
            del o, qa, ka, va
        del q, k, v, dout, out, stats, got, ref, wrong, f32
        torch.cuda.empty_cache()
    line["err"] = max(errs)
    return line


# (kernel, images, size, padding, the case the kernels line reports): K9a at
# the serving path's convs of one 6-frame chunk (18 planes; 256 tiles x 18
# planes = 4608 windows on the sparse final level), K9b at the
# reconstruction's 512^2 level (3 planes) and at 256^2; the line reports
# K9a at the largest dense conv and K9b at 512^2
WINOGRAD_CASES = [("K9a", 18, 64, "SAME", False), ("K9a", 18, 128, "SAME", False),
                  ("K9a", 18, 256, "SAME", True), ("K9a", 4608, 20, "VALID", False),
                  ("K9a", 4608, 18, "VALID", False), ("K9b", 3, 512, "SAME", True),
                  ("K9b", 18, 256, "SAME", False)]


def check_winograd(dev):
    """K9a at the serving path's shapes (per frame chunk of 6 frames x 3
    planes: the dense levels' SAME convs at 64^2, 128^2, 256^2; the sparse
    final level's VALID convs on 256 tiles' 20^2 and 18^2 windows) and K9b
    at the reconstruction's 512^2 level and at 256^2, C = K = 256, bf16:
    each held against its plain version on the same inputs under
    ops/winograd.excess_error (every |diff| <= 2^-7 |ref| + 2^-8 RMS(ref);
    mean |diff| <= 1e-2 of the plain version's mean distance from
    F.conv2d), a rule that must reject a kernel dropping the halo pair-row,
    one rounding its input transform once and (K9b) one that leaves the
    padded border to the affine. Timed with CUDA events beside the plain
    version, the bound (the 16 products' 2 * 16 * tiles * C * K operations
    at 989 TFLOP/s, or the bytes) and F.conv2d (cuDNN, bf16, TF32 off; for
    K9b the chain relu(a x + c) then F.conv2d, no single call computing
    it). Returns the kernels-line entries of K9a and K9b."""
    import torch
    import torch.nn.functional as Fn
    from audio_motion_avatar_tpu_torch import kernels
    from audio_motion_avatar_tpu_torch.ops import winograd as W

    lib = kernels.library("winograd")
    rect = {"K9a rectangles 32 wide": "winograd_rect_kernelILb0ELi32E",
            "K9a rectangles 16 wide": "winograd_rect_kernelILb0ELi16E",
            "K9b rectangles 32 wide": "winograd_rect_kernelILb1ELi32E",
            "K9b rectangles 16 wide": "winograd_rect_kernelILb1ELi16E"}
    print("[kernels] K9a / K9b resources: " + kernel_resources(
        "winograd", {"K9a raster": "winograd_kernel", **rect},
        {"K9a raster": lib.winograd_smem(0), **{k: lib.winograd_smem(1) for k in rect}}),
        flush=True)
    g = torch.Generator(device=dev).manual_seed(4)
    C = K = 256
    w = (torch.randn(3, 3, C, K, device=dev, generator=g) / (9 * C) ** 0.5).to(torch.bfloat16)
    b = (0.1 * torch.randn(K, device=dev, generator=g)).to(torch.bfloat16)
    w_lib = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    out, worst = {}, {}
    for kern, N, S, padding, in_line in WINOGRAD_CASES:
        x = torch.randn(N, S, S, C, device=dev, generator=g).to(torch.bfloat16)
        if kern == "K9b":
            a = 1.0 + 0.3 * torch.randn(N, C, device=dev, generator=g)
            c = 0.3 * torch.randn(N, C, device=dev, generator=g)
            fn = lambda: W.winograd_conv3x3_gn_relu(x, w, b, a, c, padding)   # noqa: E731
            plain = lambda: W.winograd_conv3x3_gn_relu_plain(x, w, b, a, c, padding)   # noqa: E731

            def lib():
                h = torch.relu(x.float() * a[:, None, None, :] + c[:, None, None, :]).to(x.dtype)
                return Fn.conv2d(h.permute(0, 3, 1, 2), w_lib, b, padding=1).permute(0, 2, 3, 1)
            wrongs = [("leaves the border to the affine",
                       lambda: winograd_border_not_zeroed(x, w, b, a, c)),
                      ("rounds its input transform once",
                       lambda: winograd_single_rounding(x, w, b, padding, (a, c)))]
            extra_bytes = 2 * a.numel() * 4
        else:
            fn = lambda: W.winograd_conv3x3(x, w, b, padding)   # noqa: E731
            plain = lambda: W.winograd_conv3x3_plain(x, w, b, padding)   # noqa: E731

            def lib():
                return Fn.conv2d(x.permute(0, 3, 1, 2), w_lib, b,
                                 padding=1 if padding == "SAME" else 0).permute(0, 2, 3, 1)
            wrongs = [("drops the halo pair-row", lambda: winograd_drop_halo(x, w, b, padding)),
                      ("rounds its input transform once",
                       lambda: winograd_single_rounding(x, w, b, padding))]
            extra_bytes = 0
        got, ref, direct = fn(), plain(), lib()
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        excess, mean = W.excess_error(got, ref, direct)
        wrong_read = []
        for name, wrong in wrongs:
            we, wm = W.excess_error(wrong(), ref, direct)
            wrong_read.append(f"a version that {name}: {we:.3f} / {wm:.3f}")
            if not (we > 1.0 or wm > 1.0):
                raise AssertionError(f"the {kern} rule at {N}x{S}^2 {padding} does not reject "
                                     f"a version that {name}")
        torch.cuda.empty_cache()
        Hh, Wh = W._tiles(x.shape, w.shape, padding)
        tiles = N * Hh * Wh
        nbytes = 2 * (x.numel() + w.numel() + got.numel()) + 4 * K + extra_bytes
        bound_ms, by = bound(2.0 * 16 * tiles * C * K, PEAK_BF16_FLOPS, nbytes)
        ms = time_ms(fn, 10)
        plain_ms = time_ms(plain, 2)
        lib_ms = time_ms(lib, 10)
        shape = f"({N}, {S}^2, {C}) {padding}"
        print(f"[kernels] {kern} {'winograd_gn' if kern == 'K9b' else 'winograd'} {shape} "
              f"bf16: max|diff|={err:.3e} against the plain version; excess {excess:.3f}, "
              f"mean {mean:.3f} (tol 1 each); {'; '.join(wrong_read)}; {ms:.4f} ms "
              f"({2.0 * 16 * tiles * C * K / ms / 1e9:.1f} TFLOP/s of the 16 products), "
              f"plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({by}; bytes "
              f"{nbytes / PEAK_BYTES * 1e3:.4f} ms), "
              f"{'relu(a x + c) then F.conv2d (chain)' if kern == 'K9b' else 'F.conv2d'} "
              f"{lib_ms:.4f} ms", flush=True)
        if not (excess <= 1.0 and mean <= 1.0 and torch.isfinite(got).all()):
            raise AssertionError(f"kernel {kern} disagrees with its plain version at {shape}: "
                                 f"excess {excess}, mean {mean}")
        worst[kern] = max(worst.get(kern, 0.0), err)
        if in_line:
            out[kern] = {"name": "winograd_gn" if kern == "K9b" else "winograd",
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": by, "library_ms": lib_ms, "shape": shape + " bf16"}
        del x, got, ref, direct
        torch.cuda.empty_cache()
    return [dict(out[k], err=worst[k]) for k in ("K9a", "K9b")]


def winograd_single_rounding(x, w, b, padding, gn=None):
    """K9a (gn None) or K9b broken on purpose: the input transform taken in
    fp32 from the bf16 window and rounded once, not twice (the plain core on
    the fp32 window, the products taking it in U's bf16)."""
    from audio_motion_avatar_tpu_torch.ops import winograd as W
    Hh, Wh = W._tiles(x.shape, w.shape, padding)
    xn = x if gn is None else W._affine_relu(x, *gn).to(x.dtype)
    u = W.transform_kernel(w).to(x.dtype)
    return W._wino_plain(W._pad(xn, padding).float(), u, b.float(), Hh, Wh).to(x.dtype)


def winograd_drop_halo(x, w, b, padding, strip=8):
    """K9a broken on purpose: the tile row that ends each strip of `strip`
    tile rows reads zeros for the last pair-row of its window (the pair-row
    below the strip, the TPU kernel's halo block)."""
    import torch
    from audio_motion_avatar_tpu_torch.ops import winograd as W
    Hh, Wh = W._tiles(x.shape, w.shape, padding)
    xp = W._pad(x, padding)
    u = W.transform_kernel(w).to(x.dtype)
    last = torch.arange(strip - 1, Hh, strip, device=x.device)
    cut = xp.clone()
    cut[:, torch.cat([2 * last + 2, 2 * last + 3])] = 0
    out = W._wino_plain(xp, u, b.float(), Hh, Wh)
    rows = torch.cat([2 * last, 2 * last + 1])
    out[:, rows] = W._wino_plain(cut, u, b.float(), Hh, Wh)[:, rows]
    return out


def winograd_border_not_zeroed(x, w, b, a, c):
    """K9b (SAME) broken on purpose: the padded border goes through the
    affine too and reads relu(c) instead of 0."""
    from audio_motion_avatar_tpu_torch.ops import winograd as W
    Hh, Wh = W._tiles(x.shape, w.shape, "SAME")
    xp = W._affine_relu(W._pad(x, "SAME"), a, c).to(x.dtype)
    u = W.transform_kernel(w).to(x.dtype)
    return W._wino_plain(xp, u, b.float(), Hh, Wh)


def parent_library(parent, name):
    """The parent commit's build of csrc/<name>.cu, from the tree unpacked at
    `parent` (its audio_motion_avatar_tpu_torch/csrc), compiled with the
    port's nvcc flags for that kernel (--fmad=false for the splat kernels)
    into build/parent/ and loaded with the C functions of this tree's
    kernels.KERNELS[name] that it has (their signatures unchanged)."""
    import ctypes
    from audio_motion_avatar_tpu_torch import kernels
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "parent")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"lib{name}.so")
    src = os.path.join(parent, "audio_motion_avatar_tpu_torch", "csrc", f"{name}.cu")
    subprocess.run([kernels._nvcc(), *kernels._BASE_FLAGS, *kernels.KERNELS[name][1], "-o", out,
                    src], check=True)
    lib = ctypes.CDLL(out)
    for fn, (argtypes, restype) in kernels.KERNELS[name][2].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
    return lib


def through(name, lib, fn):
    """fn, a call of this tree's wrapper, with kernel `name` taken from
    `lib` (an earlier build): the same checks, allocations and launch."""
    from audio_motion_avatar_tpu_torch import kernels

    def run():
        saved = kernels._loaded.get(name)
        kernels._loaded[name] = lib
        try:
            return fn()
        finally:
            kernels._loaded[name] = saved
    return run


def parent_segments(parent, lib, args):
    """A call of the parent's kernel S (lib) on args, those of
    composite_segments: through this tree's wrapper where the parent's
    launch takes the tile order's scratch as this tree's does, else (before
    the tile order) with its own signature and the same output."""
    import ctypes
    import torch
    from audio_motion_avatar_tpu_torch import kernels
    from audio_motion_avatar_tpu_torch.ops import splat_segmented as ss

    with open(os.path.join(parent, "audio_motion_avatar_tpu_torch", "csrc",
                           "splat_segments.cu")) as f:
        if "int* order, float* out" in f.read():
            return through("splat_segments", lib, lambda: ss.composite_segments(*args))
    launch = lib.splat_segments_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    launch.argtypes, launch.restype = [P, ctypes.c_longlong, P, P, I, I, I, P, P], I
    params, starts, counts, tx, tiles_per_frame = args

    def run():
        out = torch.empty(starts.shape[0], 256, 3, device=params.device)
        kernels.check(launch(params.data_ptr(), params.shape[1], starts.data_ptr(),
                             counts.data_ptr(), starts.shape[0], tx, tiles_per_frame,
                             out.data_ptr(), kernels.stream_ptr(params.device)),
                      "parent splat_segments")
        return out
    return run


def compare_parent(dev, parent):
    """The parent commit's S, A, K1, K2, A-bwd and K9a / K9b beside this
    tree's, at S's serving shape and at every shape of check_attention and
    check_attention_stage1 (A), of check_tiles_bwd (K1, K2),
    check_attention_bwd and check_winograd, on the same inputs, each
    through this tree's wrapper (`through`: the parent's wrappers were the
    same), in turns (parent, this tree, this tree,
    parent), CUDA-event means of 10 (A) or 5 calls, and for A also the
    device time alone (graph_ms: at the small shapes the host's work per
    call outlasts the kernel) and scaled_dot_product_attention's time (the
    key mask as a boolean attn_mask) as a yardstick; this tree held against
    the parent's outputs under each kernel's rule (A, A-bwd:
    ops/attention.excess_error; S, K1: bit-equality; K2: bwd_close;
    K9a / K9b: max|diff|)."""
    import torch
    import torch.nn.functional as Fn
    from audio_motion_avatar_tpu_torch.ops import attention as at
    from audio_motion_avatar_tpu_torch.ops import splat_tiles as st
    from audio_motion_avatar_tpu_torch.ops import winograd as W

    from audio_motion_avatar_tpu_torch.ops import splat_segmented as ss

    libs = {name: parent_library(parent, name)
            for name in ("splat_segments", "attention", "splat_tiles", "splat_tiles_bwd",
                         "attention_bwd", "winograd")}
    # S, redesigned on the walk it shares with K1: each cut an identity, so
    # bit-identical to the parent's
    args = segment_inputs(dev)[0]

    def new():
        return ss.composite_segments(*args)

    old = parent_segments(parent, libs["splat_segments"], args)
    same = torch.equal(new(), old())
    t = [time_ms(f, 10) for f in (old, new, new, old)]
    print(f"[parent] S serving segments: parent {t[0]:.4f} / {t[3]:.4f} ms, this tree {t[1]:.4f} "
          f"/ {t[2]:.4f} ms; this tree bit-identical to the parent: {same}", flush=True)
    if not same:
        raise AssertionError("kernel S differs from the parent's")
    del args
    g = torch.Generator(device=dev).manual_seed(7)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=g).to(torch.bfloat16)

    ptv3_mask = torch.ones(354, 512, dtype=torch.bool, device=dev)
    ptv3_mask[58::59, 30000 - 58 * 512:] = False
    attn_cases = [("audio", 2, 8, 6304, 6304, None), ("audio q_tail", 2, 8, 3152, 6304, None),
                  ("ptv3 masked", 354, 4, 512, 512, ptv3_mask)]
    attn_cases += [(f"stage-1 {name}", 1, H, Sq, Skv, None)
                   for name, H, Sq, Skv in stage1_attention_shapes()]
    for name, B, H, Sq, Skv, m in attn_cases:
        q, k, v = rnd(B, H, Sq, 64), rnd(B, H, Skv, 64), rnd(B, H, Skv, 64)

        def new():
            return at.attention(q, k, v, 0.125, m)

        old = through("attention", libs["attention"], new)
        ref = at.attention_plain(q.float(), k.float(), v.float(), 0.125, m)
        excess = (at.excess_error(old(), ref), at.excess_error(new(), ref))
        same = at.excess_error(new(), old().float())
        t = [time_ms(f, 10) for f in (old, new, new, old)]
        d = [graph_ms(f) for f in (old, new, new, old)]
        sdpa = time_ms(lambda: Fn.scaled_dot_product_attention(
            q, k, v, attn_mask=None if m is None else m[:, None, None, :], scale=0.125), 10)
        flops = 4.0 * B * H * Sq * Skv * 64
        print(f"[parent] A {name} ({B}, {H}, {Sq}, {Skv}): parent {t[0]:.4f} / {t[3]:.4f} ms, "
              f"this tree {t[1]:.4f} / {t[2]:.4f} ms ({flops / min(t[1], t[2]) / 1e9:.1f} "
              f"TFLOP/s), x{min(t[0], t[3]) / min(t[1], t[2]):.2f}; device time a launch (CUDA "
              f"graph): parent {d[0]:.4f} / {d[3]:.4f} ms, this tree {d[1]:.4f} / {d[2]:.4f} ms, "
              f"x{min(d[0], d[3]) / min(d[1], d[2]):.2f}; scaled_dot_product_attention {sdpa:.4f} "
              f"ms; excess against the fp32 plain version: parent {excess[0]:.3f}, this tree "
              f"{excess[1]:.3f}; this tree against the parent's output under the A rule: "
              f"{same:.3f}", flush=True)
        del q, k, v, ref
        torch.cuda.empty_cache()
    for name, Wd, Ht, windows in K2_CASES:   # K1 at the same shapes
        packed, tx, T, valid = packed_views(dev, Wd, Ht, windows)

        def new():
            return st.composite_tiles(packed, tx, T)

        old = through("splat_tiles", libs["splat_tiles"], new)
        got, want = new(), old()
        same, diff = torch.equal(got, want), float((got - want).abs().max())
        t = [time_ms(f, 5) for f in (old, new, new, old)]
        print(f"[parent] K1 {name} {tuple(packed.shape)}, {valid} valid entries: parent "
              f"{t[0]:.4f} / {t[3]:.4f} ms, this tree {t[1]:.4f} / {t[2]:.4f} ms, "
              f"x{min(t[0], t[3]) / min(t[1], t[2]):.2f}; this tree against the parent's output: "
              f"max|diff| {diff:.3e}, bit-identical {same}", flush=True)
        if not same:
            raise AssertionError(f"kernel K1 differs from the parent's at {name}")
        del packed, got, want
        torch.cuda.empty_cache()
    for name, Wd, Ht, windows in K2_CASES:
        packed, tx, T, valid = packed_views(dev, Wd, Ht, windows)
        gr = torch.randn(packed.shape[0], st.P, 3, device=dev, generator=g)

        def new():
            return st.composite_tiles_bwd(packed, gr, tx, T)

        old = through("splat_tiles_bwd", libs["splat_tiles_bwd"], new)
        close = bwd_close(new(), old())
        t = [time_ms(f, 5) for f in (old, new, new, old)]
        print(f"[parent] K2 {name} {tuple(packed.shape)}, {valid} valid entries: parent "
              f"{t[0]:.3f} / {t[3]:.3f} ms, this tree {t[1]:.3f} / {t[2]:.3f} ms, "
              f"x{min(t[0], t[3]) / min(t[1], t[2]):.2f}; this tree against the parent's output "
              f"under bwd_close: {close:.3f}", flush=True)
        del packed, gr
        torch.cuda.empty_cache()
    for name, B, H, Sq, Skv, m in attention_bwd_cases(dev):
        q, dout = (torch.randn(B, H, Sq, 64, device=dev, generator=g).bfloat16() for _ in range(2))
        k, v = (torch.randn(B, H, Skv, 64, device=dev, generator=g).bfloat16() for _ in range(2))
        out, stats = at._attention_kernel(q, k, v, 0.125, m, True)

        def new():
            return at.attention_bwd(q, k, v, 0.125, m, out, stats, dout)

        old = through("attention_bwd", libs["attention_bwd"], new)
        same = [at.excess_error(a, b.float()) for a, b in zip(new(), old())]
        t = [time_ms(f, 5) for f in (old, new, new, old)]
        flops = 10.0 * B * H * Sq * Skv * 64
        print(f"[parent] A-bwd {name} ({B}, {H}, {Sq}, {Skv}): parent {t[0]:.4f} / {t[3]:.4f} ms, "
              f"this tree {t[1]:.4f} / {t[2]:.4f} ms ({flops / min(t[1], t[2]) / 1e9:.1f} "
              f"TFLOP/s), x{min(t[0], t[3]) / min(t[1], t[2]):.2f}; this tree against the "
              f"parent's outputs under the A rule: {max(same):.3f}", flush=True)
        del q, k, v, dout, out, stats
        torch.cuda.empty_cache()
    C = K = 256
    w = (torch.randn(3, 3, C, K, device=dev, generator=g) / (9 * C) ** 0.5).to(torch.bfloat16)
    b = (0.1 * torch.randn(K, device=dev, generator=g)).to(torch.bfloat16)
    for kern, N, S, padding, _ in WINOGRAD_CASES:
        x = torch.randn(N, S, S, C, device=dev, generator=g).to(torch.bfloat16)
        a = c = None
        if kern == "K9b":
            a = 1.0 + 0.3 * torch.randn(N, C, device=dev, generator=g)
            c = 0.3 * torch.randn(N, C, device=dev, generator=g)
        Hh, Wh = W._tiles(x.shape, w.shape, padding)

        def new():
            if a is None:
                return W.winograd_conv3x3(x, w, b, padding)
            return W.winograd_conv3x3_gn_relu(x, w, b, a, c, padding)

        old = through("winograd", libs["winograd"], new)
        got, want = new(), old()
        diff = float((got.float() - want.float()).abs().max())
        same = torch.equal(got.view(torch.int16), want.view(torch.int16))
        t = [time_ms(f, 5) for f in (old, new, new, old)]
        flops = 2.0 * 16 * N * Hh * Wh * C * K
        print(f"[parent] {kern} ({N}, {S}^2, {C}) {padding}: parent {t[0]:.4f} / {t[3]:.4f} ms, "
              f"this tree {t[1]:.4f} / {t[2]:.4f} ms ({flops / min(t[1], t[2]) / 1e9:.1f} "
              f"TFLOP/s), x{min(t[0], t[3]) / min(t[1], t[2]):.2f}; max|diff| against the "
              f"parent {diff:.3e}, bit-identical {same}", flush=True)
        del got, want
        del x
        torch.cuda.empty_cache()


def tame_seeded_weights(model):
    """Seeded weights stand in for a checkpoint: keep the decoded body
    upright and near the origin (random root rotations and translations
    would move it out of the orbiting cameras' view), and damp the token
    update so the AR steps keep the tokens O(0.1) as trained weights do.
    Undamped, each step adds an O(1) random update: the token std grows by
    ~1 a request, the head outputs follow, and by the third request the
    opacities have collapsed and the frames are blank."""
    import torch
    dec = model.smpl_decoder
    with torch.no_grad():
        model.audio_triplane.transformer.proj_out.weight.mul_(0.01)
        dec.transl.weight.mul_(0.01)
        dec.transl.bias.zero_()
        dec.body_root_pose.weight.mul_(0.01)
        dec.body_root_pose.bias.copy_(torch.tensor([1.0, 0, 0, 0, 1, 0]))


def check_small(dev):
    """Tiny serving rollouts on the card vs the CPU (plain versions): fp32
    with the tiny 8-wide heads (kernels Q and S), then bf16 with 64-wide
    audio heads, so that the audio self-attention runs through kernel A."""
    import dataclasses

    import torch
    from audio_motion_avatar_tpu_torch.models.config import AvatarConfig, serving_config
    from audio_motion_avatar_tpu_torch.ops import attention as at
    from audio_motion_avatar_tpu_torch.ops import smplx as smplx_ops
    from audio_motion_avatar_tpu_torch.serve import build_rollout, synthetic_inputs
    from audio_motion_avatar_tpu_torch.weights import perturb_heads

    model = smplx_ops.synthetic_model(seed=0, num_verts=300)

    def run(cfg, d, dtype=None):
        r = build_rollout(cfg, device=d, dtype=dtype, smplx_model=model, seed=0)
        perturb_heads(r.model, seed=1, std=0.05)
        tame_seeded_weights(r.model)
        tri, smpl, audio, cams = synthetic_inputs(cfg, 2, d, seed=0)
        return [x.float().cpu() for x in r(tri, smpl, audio, cams)[:3]]

    def dist(a, b):    # frames mean|diff|, tokens max|diff|
        return (float((a[0] - b[0]).abs().mean()),
                max(float((a[i] - b[i]).abs().max()) for i in (1, 2)))

    tiny = AvatarConfig.tiny(image_size=(32, 32))
    cfg = serving_config(tiny, num_upsample_blocks=2, max_per_tile=512,
                         upsampler_norm="affine")
    card = run(cfg, dev)
    frames_diff, tok_diff = dist(card, run(cfg, "cpu"))
    print(f"[small] tiny fp32 rollout card vs CPU: frames mean|diff|="
          f"{frames_diff:.3e} (tol 1e-3), tokens max|diff|={tok_diff:.3e}",
          flush=True)
    if not (frames_diff <= 1e-3 and torch.isfinite(card[0]).all()):
        raise AssertionError("tiny rollout on the card disagrees with the CPU")

    cfg = dataclasses.replace(cfg, audio_transformer_head_dim=at.KERNEL_HEAD_DIM)
    at.attention.launches = 0
    card = run(cfg, dev, torch.bfloat16)
    launches = at.attention.launches
    cpu_bf16, cpu_fp32 = run(cfg, "cpu", torch.bfloat16), run(cfg, "cpu")
    got, noise = dist(card, cpu_bf16), dist(cpu_bf16, cpu_fp32)
    want = cfg.audio_transformer_layers * cfg.triplane_output_frames
    print(f"[small] tiny bf16 rollout, 64-wide audio heads: kernel A launches "
          f"{launches} (expected {want}); card vs CPU bf16: frames "
          f"mean|diff|={got[0]:.3e}, tokens max|diff|={got[1]:.3e}; CPU bf16 "
          f"vs CPU fp32: {noise[0]:.3e}, {noise[1]:.3e} (tol 3x these)",
          flush=True)
    if launches != want:
        raise AssertionError(f"kernel A launches {launches} != {want}")
    if not (got[0] <= 3 * noise[0] and got[1] <= 3 * noise[1]
            and torch.isfinite(card[0]).all()):
        raise AssertionError("tiny bf16 rollout on the card disagrees with the CPU")


def run_rollout(dev, requests=3, tag="rollout", **knobs):
    """The full-width bf16 serving rollout (knobs: config overrides, e.g.
    upsampler_conv and audio_attn_impl): one warm-up and `requests` timed
    requests. Returns the launches, (rollout, tokens, first request) and the
    fps."""
    import numpy as np
    import torch
    from audio_motion_avatar_tpu_torch.models.config import AvatarConfig, serving_config
    from audio_motion_avatar_tpu_torch.ops import attention as at
    from audio_motion_avatar_tpu_torch.ops import splat_segmented as ss
    from audio_motion_avatar_tpu_torch.ops import triplane as tp
    from audio_motion_avatar_tpu_torch.ops import winograd as W
    from audio_motion_avatar_tpu_torch.serve import build_rollout, serve, synthetic_inputs
    from audio_motion_avatar_tpu_torch.weights import perturb_heads

    cfg = serving_config(AvatarConfig(), image_size=(512, 512),
                         upsampler_norm="affine", **knobs)
    t0 = time.perf_counter()
    roll = build_rollout(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    perturb_heads(roll.model, seed=1, std=1e-2)
    tame_seeded_weights(roll.model)
    tri, smpl, audio, cams = synthetic_inputs(roll.model.cfg, 2, dev, seed=0)
    print(f"[{tag}] built in {time.perf_counter() - t0:.1f} s ({knobs or 'direct convs, flash'})",
          flush=True)
    rng = np.random.RandomState(1)

    def request():
        a = rng.randn(*audio.shape).astype(np.float32) * 0.1
        return torch.as_tensor(a, device=dev), cams

    t0 = time.perf_counter()
    list(serve(roll, tri, smpl, [(audio, cams)]))
    torch.cuda.synchronize()
    print(f"[{tag}] warm-up request {1e3 * (time.perf_counter() - t0):.1f} ms",
          flush=True)
    counters = (at.attention, tp.quad_rows, ss.composite_segments, W.winograd_conv3x3)
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    times, frames = [], []
    reqs = [request() for _ in range(requests)]
    torch.cuda.synchronize()
    it = serve(roll, tri, smpl, reqs)
    for _ in range(requests):
        t0 = time.perf_counter()
        rendered, pred = next(it)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        frames.append(rendered)
    launches = {fn.__name__: fn.launches for fn in counters}

    mcfg = roll.model.cfg
    B, T_out = rendered.shape[:2]
    n_chunks = (B * T_out) // mcfg.frames_per_chunk
    dec0_d = mcfg.ptv3_dec_channels[0] // mcfg.ptv3_dec_heads[0]
    # K9a: every ResBlock conv of a chunk's upsampler pass (the dense
    # levels' and the sparse final level's; the affine norm fuses nothing)
    per_request = {
        "attention": mcfg.audio_transformer_layers * T_out
        + (mcfg.ptv3_dec_depths[0] * n_chunks if dec0_d == 64 else 0),
        "quad_rows": n_chunks, "composite_segments": n_chunks,
        "winograd_conv3x3": upsampler_launches(mcfg)[0] * n_chunks}
    expected = {k: v * requests for k, v in per_request.items()}
    print(f"[{tag}] launches {launches} expected {expected}", flush=True)
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    for i, fr in enumerate(frames):
        if tuple(fr.shape) != (2, 6, 512, 512, 3) or not torch.isfinite(fr).all():
            raise AssertionError(f"request {i}: bad frames {tuple(fr.shape)}")
        std = fr.float().reshape(B * T_out, -1).std(dim=1)
        white = float((fr > 0.999).float().mean())
        print(f"[{tag}] request {i}: {1e3 * times[i]:.1f} ms, per-frame std "
              f"min {float(std.min()):.4f} max {float(std.max()):.4f}, "
              f"white share {white:.4f}", flush=True)
        if not (std > 0.01).all() or white >= 1.0:
            raise AssertionError(f"request {i}: blank frames (std {std.tolist()})")
    mean_s = sum(times) / len(times)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[{tag}] fps {B * T_out / mean_s:.2f} (= {B * T_out} / "
          f"{1e3 * mean_s:.1f} ms), peak memory {peak / 2**30:.2f} GiB", flush=True)
    return launches, (roll, tri, smpl, reqs[0]), B * T_out / mean_s


def profile_rollout(roll, tri, smpl, req, tag="profile"):
    """Where one request's time goes: host-clock time of each stage of the
    rollout, run one after another with a synchronize between them, then
    one whole request under torch.profiler: the device's busy share (sum of
    kernel times over the wall time) and the kernels that take the most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from audio_motion_avatar_tpu_torch.models.triplane_encoder import reshape_params

    model = roll.model
    audio, cams = req

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    with torch.no_grad():
        (out_tri, out_smpl), ms_audio = timed(lambda: model.audio_triplane(audio, tri, smpl))
        B, T = out_smpl.shape[:2]
        pred, ms_dec = timed(lambda: reshape_params(model.smpl_decoder(
            out_smpl.reshape((B * T,) + out_smpl.shape[2:])), (B, T)))
        (_, gs), ms_render = timed(lambda: model.renderer(roll.statics, out_tri, cams, pred))
        n_entries = segment_entries(model.renderer.cfg, gs, cams)
    print(f"[{tag}] stages: audio rollout {ms_audio:.1f} ms, SMPL-X decoder "
          f"{ms_dec:.1f} ms, renderer {ms_render:.1f} ms", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = timed(lambda: roll(tri, smpl, audio, cams))
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = {e.key: (e.self_device_time_total, e.count) for e in kernels}
    busy = sum(t for t, _ in dev_us.values()) / 1e3
    if busy == 0.0:
        print(f"[{tag}] the profiler recorded no device time: busy share not "
              "measured", flush=True)
        return
    print(f"[{tag}] request under the profiler {wall:.1f} ms, kernels "
          f"{busy:.1f} ms, device busy share {busy / wall:.3f}", flush=True)
    top = sorted(dev_us.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (us, count) in top:
        print(f"[{tag}]   {us / 1e3:9.3f} ms {count:5d}x  {name[:110]}", flush=True)
    s_us = sum(t for k, (t, _) in dev_us.items() if "seg_composite_kernel" in k)
    s_n = sum(n for k, (_, n) in dev_us.items() if "seg_composite_kernel" in k)
    print(f"[{tag}] kernel S: {s_us / 1e3:.4f} ms in {s_n} launches, {n_entries} segment "
          f"entries (the staged run's gaussians binned again); {s_us / 1e3 / busy:.5f} of the kernels' time, {s_us / 1e3 / wall:.5f} of "
          f"the request", flush=True)


def segment_entries(cfg, gaussians, cams):
    """The segment entries kernel S takes for the renderer's gaussians
    (BT, N, ...) of one request: its binning again, all frames at once (a
    tile's count does not depend on the launch that holds its frame)."""
    from audio_motion_avatar_tpu_torch.ops import splat_segmented as ss

    H, W = cfg.image_size
    counts = ss.pack_frames_segmented(
        gaussians["xyz"], gaussians["rot"], gaussians["scale"], gaussians["opacity"],
        gaussians["color"], cams["intrinsic"].reshape(-1, 3, 3),
        cams["extrinsic"].reshape(-1, 4, 4), W, H, max_per_tile=cfg.max_per_tile,
        max_window=cfg.splat_max_window, large_cap=cfg.splat_large_cap)[2]
    return int(counts.sum())


def frames_distance(got, want):
    """(mean |diff|, max |diff|, mean squared diff, PSNR in dB) of two
    frame tensors in [0, 1]."""
    import math
    diff = (got.float() - want.float()).abs()
    mse = float((diff ** 2).mean())
    return float(diff.mean()), float(diff.max()), mse, 10 * math.log10(1.0 / max(mse, 1e-20))


def frames_close(got, want, name, against="the direct convs'"):
    """A serving / render knob of the bf16 rounding class (the Winograd
    convs, the sparse samplers) against `against`'s frames on the same
    inputs and weights: mean |diff| <= 1e-2 and PSNR >= 40 dB (the JAX
    package's gate for such a knob, its tests/test_demo_golden.py)."""
    mean, mx, _, psnr = frames_distance(got, want)
    print(f"[{name}] frames against {against} on the same inputs: mean|diff|="
          f"{mean:.3e} (tol 1e-2), max|diff|={mx:.3e}, PSNR {psnr:.2f} dB (tol 40)",
          flush=True)
    if not (mean <= 1e-2 and psnr >= 40.0):
        raise AssertionError(f"{name}: frames differ from {against} beyond the "
                             "rounding class")


def frames_ok(frames, name):
    """Finite frames, every one with some structure and not all white."""
    import torch
    n = frames.shape[0] * frames.shape[1]
    if not torch.isfinite(frames).all():
        raise AssertionError(f"{name}: non-finite frames")
    std = frames.float().reshape(n, -1).std(dim=1)
    white = float((frames > 0.999).float().mean())
    print(f"[{name}] frames {tuple(frames.shape)}: per-frame std min "
          f"{float(std.min()):.4f} max {float(std.max()):.4f}, white share {white:.4f}",
          flush=True)
    if not (std > 0.01).all() or white >= 1.0:
        raise AssertionError(f"{name}: blank frames (std {std.tolist()})")


def visible_heads(model, scale_bias=1.0, opacity_bias=2.0):
    """Seeded heads draw gaussians of exp(-1 - 3.9) = 0.007 world units at
    opacity 0.1, under a pixel at 64^2, and perturbed position, scale and
    opacity heads throw them off the body or fade them out. Uniform, larger,
    more opaque gaussians on the body, coloured by the (perturbed) colour
    head, make the tiny frames worth comparing."""
    import torch
    r = model.renderer
    with torch.no_grad():
        r.scaling_layer.bias.fill_(scale_bias)
        r.opacity_layer.bias.fill_(opacity_bias)
        for layer in (r.xyz_layer, r.scaling_layer, r.opacity_layer):
            layer.weight.zero_()


def check_small_stage1(dev):
    """Tiny reconstructions on the card vs the CPU (plain versions)."""
    import dataclasses

    import torch
    from audio_motion_avatar_tpu_torch.data.synthetic import make_batch, to_device
    from audio_motion_avatar_tpu_torch.models.config import AvatarConfig
    from audio_motion_avatar_tpu_torch.ops import attention as at
    from audio_motion_avatar_tpu_torch.ops import smplx as smplx_ops
    from audio_motion_avatar_tpu_torch.reconstruct import build_reconstructor
    from audio_motion_avatar_tpu_torch.weights import perturb_heads

    body = smplx_ops.synthetic_model(seed=0, num_verts=300)
    ref_np, test_np = make_batch(1, 1, (64, 64), seed=0), make_batch(1, 3, (64, 64), seed=1)

    def run(cfg, d, dtype=None, image_tokens=None):
        rec = build_reconstructor(cfg, device=d, dtype=dtype, smplx_model=body, seed=0)
        perturb_heads(rec.model, seed=1, std=0.05)
        visible_heads(rec.model)
        if image_tokens is not None:
            flat = image_tokens.to(d).reshape((-1,) + image_tokens.shape[2:])
            rec.model.sapiens_encoder.forward = lambda images: flat
        out = rec(to_device(ref_np, d), to_device(test_np, d))
        return [x.float().cpu() for x in (out.reference, out.novel, out.output.image_tokens,
                                          out.output.triplane_tokens)]

    def dist(a, b):    # frames mean|diff| (reference and novel), tokens max|diff|
        return (float(torch.cat([(a[i] - b[i]).abs().flatten() for i in (0, 1)]).mean()),
                float((a[3] - b[3]).abs().max()))

    cfg = AvatarConfig.tiny(image_size=(64, 64))
    cpu = run(cfg, "cpu")
    card = run(cfg, dev, image_tokens=cpu[2])
    frames_diff, tok_diff = dist(card, cpu)
    print(f"[small stage 1] tiny fp32 reconstruction card vs CPU (the CPU's image "
          f"tokens on both): frames mean|diff|={frames_diff:.3e} (tol 1e-3), "
          f"triplane tokens max|diff|={tok_diff:.3e}", flush=True)
    if not (frames_diff <= 1e-3 and torch.isfinite(card[0]).all()):
        raise AssertionError("tiny reconstruction on the card disagrees with the CPU")

    cfg = dataclasses.replace(cfg, smplx_transformer_head_dim=at.KERNEL_HEAD_DIM,
                              cross_transformer_head_dim=at.KERNEL_HEAD_DIM)
    at.attention.launches = 0
    card = run(cfg, dev, torch.bfloat16)
    launches = at.attention.launches
    cpu_bf16, cpu_fp32 = run(cfg, "cpu", torch.bfloat16), run(cfg, "cpu")
    got, noise = dist(card, cpu_bf16), dist(cpu_bf16, cpu_fp32)
    want = 2 * (cfg.smplx_transformer_layers + cfg.cross_transformer_layers)
    print(f"[small stage 1] tiny bf16 reconstruction, 64-wide predictor and fusion "
          f"heads: kernel A launches {launches} (expected {want}); card vs CPU bf16: "
          f"frames mean|diff|={got[0]:.3e}, tokens max|diff|={got[1]:.3e}; CPU bf16 vs "
          f"CPU fp32: {noise[0]:.3e}, {noise[1]:.3e} (tol 3x these)", flush=True)
    if launches != want:
        raise AssertionError(f"kernel A launches {launches} != {want}")
    if not (got[0] <= 3 * noise[0] and got[1] <= 3 * noise[1] and noise[0] > 0
            and torch.isfinite(card[0]).all()):
        raise AssertionError("tiny bf16 reconstruction on the card disagrees with the CPU")
    frames_ok(card[0], "small stage 1 reference")
    frames_ok(card[1], "small stage 1 novel")


def reconstruction_launches(cfg):
    """Kernel launches of one reconstruction request: K1 twice (the
    reference view, then all novel views); kernel A in the ViT's layers, the
    predictor's and the fusion's layers (self + cross each) and the PTv3
    dec0 blocks, where their heads are 64 wide; K9a / K9b in the one
    upsampler pass (the reference frame)."""
    from audio_motion_avatar_tpu_torch.ops.attention import KERNEL_HEAD_DIM

    stacks = ((cfg.image_feature_dim // cfg.vit_heads, cfg.vit_depth),
              (cfg.smplx_transformer_head_dim, 2 * cfg.smplx_transformer_layers),
              (cfg.cross_transformer_head_dim, 2 * cfg.cross_transformer_layers),
              (cfg.ptv3_dec_channels[0] // cfg.ptv3_dec_heads[0], cfg.ptv3_dec_depths[0]))
    k9a, k9b = upsampler_launches(cfg) if cfg.upsample_triplane else (0, 0)
    return {"composite_tiles": 2,
            "attention": sum(n for d, n in stacks if d == KERNEL_HEAD_DIM),
            "winograd_conv3x3": k9a, "winograd_conv3x3_gn_relu": k9b}


def run_reconstruction(dev, requests=3, tag="reconstruct", **knobs):
    """The full-width bf16 stage-1 reconstruction: B = 1, a 1024^2 reference
    view and 8 novel views per request (knobs: config overrides, e.g.
    upsampler_conv). Returns the launches, the last request's (reference,
    novel) frames on the CPU and the mean ms a request."""
    import dataclasses

    import torch
    from audio_motion_avatar_tpu_torch.data.synthetic import make_batch, to_device
    from audio_motion_avatar_tpu_torch.models.config import AvatarConfig
    from audio_motion_avatar_tpu_torch.ops import attention as at
    from audio_motion_avatar_tpu_torch.ops import splat_tiles as st
    from audio_motion_avatar_tpu_torch.ops import winograd as Wg
    from audio_motion_avatar_tpu_torch.ops.splat_tiles import render_multi_view
    from audio_motion_avatar_tpu_torch.reconstruct import build_reconstructor
    from audio_motion_avatar_tpu_torch.weights import perturb_heads

    cfg = dataclasses.replace(AvatarConfig(), **knobs)
    H, W = cfg.image_size
    t0 = time.perf_counter()
    rec = build_reconstructor(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    perturb_heads(rec.model, seed=1, std=1e-2)
    visible_heads(rec.model, scale_bias=-1.0, opacity_bias=0.0)
    n_params = sum(p.numel() for p in rec.model.parameters())
    print(f"[{tag}] built in {time.perf_counter() - t0:.1f} s, "
          f"{n_params / 1e9:.3f} G parameters ({knobs or 'direct convs'})", flush=True)
    ref = to_device(make_batch(1, 1, (H, W), seed=0), dev)
    test = to_device(make_batch(1, 8, (H, W), seed=1), dev)
    t0 = time.perf_counter()
    rec(ref, test)
    torch.cuda.synchronize()
    print(f"[{tag}] warm-up request {1e3 * (time.perf_counter() - t0):.1f} ms",
          flush=True)

    counters = (st.composite_tiles, at.attention, Wg.winograd_conv3x3,
                Wg.winograd_conv3x3_gn_relu)
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(requests):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = rec(ref, test)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {fn.__name__: fn.launches for fn in counters}
    peak = torch.cuda.max_memory_allocated(dev)
    expected = {k: v * requests for k, v in reconstruction_launches(cfg).items()}
    print(f"[{tag}] launches {launches} expected {expected}", flush=True)
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    for name, fr in ((f"{tag} reference", out.reference),
                     (f"{tag} novel", out.novel)):
        frames_ok(fr, name)
    mean_s = sum(times) / len(times)
    print(f"[{tag}] requests {', '.join(f'{1e3 * s:.1f}' for s in times)} ms "
          f"(mean {1e3 * mean_s:.1f} ms), peak memory {peak / 2**30:.2f} GiB; metrics "
          f"{ {k: round(v, 5) for k, v in out.metrics.items()} }", flush=True)

    # where one request's time goes, stage by stage
    model, statics = rec.model, rec.statics

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, 1e3 * (time.perf_counter() - t0)

    with torch.no_grad():
        tokens, ms_vit = timed(lambda: model.sapiens_encoder(ref.video[:, 0]))
        image_tokens = tokens[:, None]
        feats, ms_feat = timed(lambda: model.image_feature(ref.video, image_tokens))
        (planes, smpl_tokens, _), ms_enc = timed(lambda: model.smplx_triplane_encoder(
            statics.smplx_model, image_tokens, ref.cam_parms, ref.smpl_parms,
            feats.reshape((1,) + feats.shape[2:])))
        (tri, _), ms_fus = timed(lambda: model.fusion_network(planes, image_tokens,
                                                              smpl_tokens))
        (_, gs), ms_ren = timed(lambda: model.renderer(statics, tri, ref.cam_parms,
                                                       ref.smpl_parms))
        gb = {k: v.reshape((1, -1) + v.shape[1:])[:, 0] for k, v in gs.items() if k != "shs"}
        _, ms_nov = timed(lambda: render_multi_view(
            gb, test.cam_parms["intrinsic"], test.cam_parms["extrinsic"], W, H,
            max_per_tile=cfg.max_per_tile))
    print(f"[{tag}] stages: ViT {ms_vit:.1f} ms, image features {ms_feat:.1f} ms, "
          f"triplane encoder {ms_enc:.1f} ms, fusion {ms_fus:.1f} ms, renderer "
          f"{ms_ren:.1f} ms, 8 novel views {ms_nov:.1f} ms", flush=True)
    return launches, (out.reference.cpu(), out.novel.cpu()), 1e3 * mean_s


def serve_from_reference(dev):
    """The serving model with its stage-1 stack: two streams' reference
    frames -> initial tokens (render off) -> one rollout request."""
    import torch
    from audio_motion_avatar_tpu_torch.data.synthetic import make_batch, to_device
    from audio_motion_avatar_tpu_torch.models.config import AvatarConfig, serving_config
    from audio_motion_avatar_tpu_torch.serve import build_rollout, serve, synthetic_inputs
    from audio_motion_avatar_tpu_torch.weights import perturb_heads

    cfg = serving_config(AvatarConfig(vit_depth=SHALLOW_VIT), image_size=(512, 512),
                         upsampler_norm="affine")
    t0 = time.perf_counter()
    roll = build_rollout(cfg, device=dev, dtype=torch.bfloat16, seed=0, stage1=True)
    perturb_heads(roll.model, seed=1, std=1e-2)
    tame_seeded_weights(roll.model)
    visible_heads(roll.model, scale_bias=-1.0, opacity_bias=0.0)
    print(f"[serve from reference] built in {time.perf_counter() - t0:.1f} s", flush=True)
    ref = to_device(make_batch(2, cfg.triplane_input_frames, cfg.image_size, seed=2), dev)
    _, _, audio, cams = synthetic_inputs(roll.model.cfg, 2, dev, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tri, smpl = roll.tokens(ref.video, ref.smpl_parms, ref.cam_parms)
    torch.cuda.synchronize()
    ms_tokens = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    rendered, _ = next(serve(roll, tri, smpl, [(audio, cams)]))
    torch.cuda.synchronize()
    ms_roll = 1e3 * (time.perf_counter() - t0)
    print(f"[serve from reference] stage-1 tokens {tuple(tri.shape)} / "
          f"{tuple(smpl.shape)} in {ms_tokens:.1f} ms (first call), token std "
          f"{float(tri.float().std()):.4f}; rollout request {ms_roll:.1f} ms (first call)",
          flush=True)
    frames_ok(rendered, "serve from reference")


def train_grads(tr):
    """The trainable parameters' gradients after a step, fp32 on the CPU."""
    return {k: p.grad.float().cpu() for k, p in tr.model.named_parameters()
            if p.grad is not None}


def grads_distance(a, b):
    """||a - b|| / ||b|| over all the gradient leaves of b."""
    import torch
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
    den = sum(float((b[k] ** 2).sum()) for k in b)
    return (num / den) ** 0.5


def seeded_trainer(stage, cfg, dev, dtype=None, body=None, seed=0, optim=None,
                   replacement_prob=0.0):
    """build_trainer with the seeded weights made to render visible
    gaussians (and, in stage 2, the rollout damped) as the other phases do."""
    from audio_motion_avatar_tpu_torch.train import build_trainer
    from audio_motion_avatar_tpu_torch.weights import perturb_heads

    tr = build_trainer(stage, cfg, device=dev, dtype=dtype, smplx_model=body, seed=seed,
                       optim=optim, replacement_prob=replacement_prob)
    full = cfg.image_size[0] >= 512
    perturb_heads(tr.model, seed=1, std=1e-2 if full else 0.05)
    if stage == 2:
        tame_seeded_weights(tr.model)
    if full:
        visible_heads(tr.model, scale_bias=-1.0, opacity_bias=0.0)
    else:
        visible_heads(tr.model)
    return tr


def attention_rounded(q, k, v, scale, kv_mask=None):
    """Kernel A's function for bf16 operands, rounding where A rounds: the
    probabilities to bf16 for the P V product, normalised after it by the
    fp32 row sum, the output to bf16; the rest in fp32."""
    import torch
    from audio_motion_avatar_tpu_torch.ops import attention as at

    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask[:, None, None, :], at.MASKED)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bhst,bhtd->bhsd", e.bfloat16().float(), v.float())
    return (out / e.sum(-1, keepdim=True)).bfloat16()


def attention_bwd_rounded(q, k, v, scale, kv_mask, dout, out=None):
    """Kernel A-bwd's function for bf16 operands, rounding where A-bwd
    rounds: P to bf16 for dV = P^T dO, dS to bf16 for dQ = dS K and
    dK = dS^T Q, Delta = rowsum(dO O) from the forward's bf16 output `out`
    (attention_rounded's when None), as the kernel takes it; the rest in
    fp32."""
    import torch
    from audio_motion_avatar_tpu_torch.ops import attention as at

    qf, kf, vf, g = q.float(), k.float(), v.float(), dout.float()
    s = torch.einsum("bhsd,bhtd->bhst", qf, kf) * scale
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask[:, None, None, :], at.MASKED)
    p = torch.softmax(s, dim=-1)
    o = attention_rounded(q, k, v, scale, kv_mask) if out is None else out
    delta = (g * o.float()).sum(-1, keepdim=True)
    dv = torch.einsum("bhst,bhsd->bhtd", p.bfloat16().float(), g)
    ds = p * (torch.einsum("bhsd,bhtd->bhst", g, vf) - delta)
    if kv_mask is not None:
        ds = ds.masked_fill(~kv_mask[:, None, None, :], 0.0)
    ds = ds.bfloat16().float()
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kf) * scale
    dk = torch.einsum("bhst,bhsd->bhtd", ds, qf) * scale
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


@contextlib.contextmanager
def kernel_rounding():
    """Within it, the plain versions of kernels A and A-bwd round where the
    kernels round (attention_rounded, attention_bwd_rounded) for bf16
    operands; fp32 operands keep the plain versions. The plain versions
    compute all of it in fp32, so without this a bf16 model on the CPU is no
    yardstick for the same model on the kernels."""
    import torch
    from audio_motion_avatar_tpu_torch.ops import attention as at

    plain, plain_bwd = at.attention_plain, at.attention_bwd_plain

    def fwd(q, k, v, scale, kv_mask=None):
        if q.dtype != torch.bfloat16:
            return plain(q, k, v, scale, kv_mask)
        return attention_rounded(q, k, v, scale, kv_mask)

    def bwd(q, k, v, scale, kv_mask, dout):
        if q.dtype != torch.bfloat16:
            return plain_bwd(q, k, v, scale, kv_mask, dout)
        return attention_bwd_rounded(q, k, v, scale, kv_mask, dout)

    at.attention_plain, at.attention_bwd_plain = fwd, bwd
    try:
        yield
    finally:
        at.attention_plain, at.attention_bwd_plain = plain, plain_bwd


@contextlib.contextmanager
def checked_backwards():
    """Within it, every launch of A-bwd and K2 is also held against a plain
    version on the very tensors the caller gave it: A-bwd's dQ / dK / dV
    against attention_bwd_rounded (the forward's own bf16 output in Delta)
    under ops/attention.excess_error, K2 against its plain version under
    bwd_close. Yields {name: the worst ratio reached} (1 or less agrees),
    with A-bwd's against the fp32 plain backward beside it
    ("attention_bwd_fp32", for the record). The launch counters count as
    they do without it."""
    from audio_motion_avatar_tpu_torch.ops import attention as at
    from audio_motion_avatar_tpu_torch.ops import splat_tiles as st

    worst = {"attention_bwd": 0.0, "composite_tiles_bwd": 0.0, "attention_bwd_fp32": 0.0}
    a_bwd, k2 = at.attention_bwd, st.composite_tiles_bwd

    def note(name, value):
        worst[name] = max(worst[name], value)

    def attention_bwd(q, k, v, scale, kv_mask, out, stats, dout):
        got = a_bwd(q, k, v, scale, kv_mask, out, stats, dout)
        ref = attention_bwd_rounded(q, k, v, scale, kv_mask, dout, out)
        note("attention_bwd", max(at.excess_error(a, b) for a, b in zip(got, ref)))
        ref = at.attention_bwd_plain(q.float(), k.float(), v.float(), scale, kv_mask,
                                     dout.float())
        note("attention_bwd_fp32", max(at.excess_error(a, b) for a, b in zip(got, ref)))
        return got

    def composite_tiles_bwd(tile_params, g, tx, tiles_per_frame=0):
        got = k2(tile_params, g, tx, tiles_per_frame)
        ref = st.composite_tiles_bwd_plain(tile_params, g, tx, tiles_per_frame)
        note("composite_tiles_bwd", bwd_close(got, ref))
        return got

    # the kernels' wrappers count their launches on the module's name
    attention_bwd.launches, composite_tiles_bwd.launches = a_bwd.launches, k2.launches
    at.attention_bwd, st.composite_tiles_bwd = attention_bwd, composite_tiles_bwd
    try:
        yield worst
    finally:
        at.attention_bwd, st.composite_tiles_bwd = a_bwd, k2
        a_bwd.launches, k2.launches = attention_bwd.launches, composite_tiles_bwd.launches


def check_small_train(dev):
    """A tiny train step of each stage on the card against the CPU (plain
    versions), the CPU's image tokens fed to both (the ViT rounds bf16
    differently on the two).

    fp32 with the tiny heads (K1, K2): loss within 1e-4 and every gradient
    within 1e-3 of the CPU's (global relative norm).

    bf16 with 64-wide heads (A and A-bwd too): every A-bwd and K2 launch of
    the card's step is held against its plain version on its own inputs
    (checked_backwards; this is what catches a wrong backward, since the
    whole step is chaotic in bf16: a rounding-level change, the kernels'
    rounding of P alone included, moves the tiny step's loss by up to ~1e-3
    and its gradients by 1-25%). The step itself is held against the CPU's
    bf16 step with the attention rounding as the kernels do
    (kernel_rounding), to 3x the CPU's own bf16-vs-fp32 distance, the
    largest over three draws of the input frames (one draw of a scalar
    distance can fall far below its usual size). The launches must equal
    the count the configuration implies.
    Also printed: the distances with the fp32 plain attention on the CPU,
    the yardstick that leaves the kernels' rounding out. Returns the bf16
    steps' bounds {stage: (loss, gradients)} (phase 18a holds its stage-2
    steps, the same configuration and batch, to them)."""
    from audio_motion_avatar_tpu_torch.models.config import AvatarConfig

    bounds = {}
    for stage in (1, 2):
        hold_train_step(dev, stage, AvatarConfig.tiny(image_size=(32, 32)), f"stage {stage}",
                        bounds=bounds, rows=2)
    return bounds


def hold_train_step(dev, stage, cfg, name, tag="small train", bounds=None, rows=1):
    """Phase 9's two holds of one tiny train step of `stage` in configuration
    `cfg` (32x32): the fp32 step card vs CPU, then the bf16 step with
    64-wide heads against the CPU's with the kernels' rounding
    (check_small_train says how). Stage 1 takes `rows` rows (one reference
    view, 3 test views each), stage 2 two. Returns the bf16 step's
    launches; its bound (loss, gradients) goes into bounds[stage]."""
    import dataclasses

    import torch
    from audio_motion_avatar_tpu_torch.data.synthetic import make_batch, to_device
    from audio_motion_avatar_tpu_torch.ops import attention as at
    from audio_motion_avatar_tpu_torch.ops import smplx as smplx_ops
    from audio_motion_avatar_tpu_torch.ops import splat_tiles as st
    from audio_motion_avatar_tpu_torch.ops import winograd as Wg
    from audio_motion_avatar_tpu_torch.training.train_state import OptimConfig

    body = smplx_ops.synthetic_model(seed=0, num_verts=300)
    size = tuple(cfg.image_size)
    counters = (at.attention, at.attention_bwd, st.composite_tiles, st.composite_tiles_bwd,
                Wg.winograd_conv3x3, Wg.winograd_conv3x3_gn_relu)
    optim = OptimConfig(learning_rate=1e-3, accumulate_steps=1)
    # (reference frames, targets) seeds of the draws; the first is the card's
    draws = ((0, 1), (2, 3), (4, 5))

    def batches(stage, cfg, d, seeds):
        ref, tgt = seeds
        if stage == 1:
            return (to_device(make_batch(rows, 1, size, seed=ref), d),
                    to_device(make_batch(rows, 3, size, seed=tgt), d))
        return (to_device(make_batch(2, cfg.triplane_input_frames, size, seed=ref), d),
                to_device(make_batch(2, cfg.triplane_output_frames, size, seed=tgt,
                                     with_audio=True, audio_dim=cfg.audio_feature_dim), d))

    def run(stage, cfg, d, dtype, tokens, seeds=draws[0]):
        tr = seeded_trainer(stage, cfg, d, dtype, body, optim=optim)
        enc = tr.model.sapiens_encoder if stage == 1 else tr.model.triplane_gaussian.sapiens_encoder
        own = None
        if tokens is None:
            own = enc(batches(stage, cfg, d, seeds)[0].video.flatten(0, 1)).cpu()
        else:
            flat = tokens.to(d)
            enc.forward = lambda images: flat
        m = tr.step(*batches(stage, cfg, d, seeds))
        return m["loss"], train_grads(tr), own

    def rounded_cpu(stage, cfg, tokens, seeds=draws[0]):
        with kernel_rounding():
            return run(stage, cfg, "cpu", torch.bfloat16, tokens, seeds)

    loss_cpu, g_cpu, tokens = run(stage, cfg, "cpu", None, None)
    loss_card, g_card, _ = run(stage, cfg, dev, None, tokens)
    dl, dg = abs(loss_card - loss_cpu) / abs(loss_cpu), grads_distance(g_card, g_cpu)
    print(f"[{tag}] {name} tiny fp32 step, card vs CPU: loss {loss_card:.6f} "
          f"vs {loss_cpu:.6f} (relative {dl:.2e}, tol 1e-4), gradients relative "
          f"{dg:.2e} (tol 1e-3)", flush=True)
    if not (dl <= 1e-4 and dg <= 1e-3):
        raise AssertionError(f"tiny {name} train step on the card disagrees with the CPU")

    cfg = dataclasses.replace(cfg, smplx_transformer_head_dim=64, cross_transformer_head_dim=64,
                              audio_transformer_head_dim=64)
    for fn in counters:
        fn.launches = 0
    with checked_backwards() as worst:
        loss_card, g_card, _ = run(stage, cfg, dev, torch.bfloat16, tokens)
    launches = {fn.__name__: fn.launches for fn in counters}
    B, T_in, T_out = (rows, 1, 3) if stage == 1 else (2, cfg.triplane_input_frames,
                                                      cfg.triplane_output_frames)
    want = train_launches(cfg, stage, B, T_in, T_out)
    loss_r, g_r, _ = rounded_cpu(stage, cfg, tokens)
    loss_p, g_p, _ = run(stage, cfg, "cpu", torch.bfloat16, tokens)
    loss_f, g_f, _ = run(stage, cfg, "cpu", None, tokens)
    noise = [(abs(loss_r - loss_f), grads_distance(g_r, g_f))]
    for seeds in draws[1:]:
        lf_, gf_, own = run(stage, cfg, "cpu", None, None, seeds)
        lr_, gr_, _ = rounded_cpu(stage, cfg, own, seeds)
        noise.append((abs(lr_ - lf_), grads_distance(gr_, gf_)))
    got = (abs(loss_card - loss_r), grads_distance(g_card, g_r))
    tol = tuple(3 * max(n[i] for n in noise) for i in (0, 1))
    print(f"[{tag}] {name} tiny bf16 step, 64-wide heads: launches {launches} "
          f"(expected {want}); A-bwd and K2 on the step's own inputs against their plain "
          f"versions: excess {worst['attention_bwd']:.3f}, "
          f"{worst['composite_tiles_bwd']:.3f} (tol 1); A-bwd against the fp32 plain "
          f"backward instead {worst['attention_bwd_fp32']:.3f}", flush=True)
    print(f"[{tag}] {name} tiny bf16 step: loss card {loss_card:.6f}, CPU bf16 "
          f"rounding as the kernels {loss_r:.6f}, CPU bf16 with the fp32 plain attention "
          f"{loss_p:.6f}, CPU fp32 {loss_f:.6f}; card vs CPU bf16 rounding as the kernels: "
          f"loss |diff| {got[0]:.3e}, gradients relative {got[1]:.3e}; that CPU bf16 vs "
          f"CPU fp32 over the draws {list(draws)}: loss "
          f"{', '.join(f'{n[0]:.3e}' for n in noise)}, gradients "
          f"{', '.join(f'{n[1]:.3e}' for n in noise)} (tol 3x the largest: "
          f"{tol[0]:.3e}, {tol[1]:.3e}); with the fp32 plain attention instead: card vs CPU "
          f"bf16 {abs(loss_card - loss_p):.3e}, {grads_distance(g_card, g_p):.3e}, CPU bf16 "
          f"vs fp32 {abs(loss_p - loss_f):.3e}, {grads_distance(g_p, g_f):.3e}; the two CPU "
          f"bf16 steps apart {abs(loss_r - loss_p):.3e}, {grads_distance(g_r, g_p):.3e}",
          flush=True)
    check_launches(f"{tag} {name}", launches, want)
    if bounds is not None:
        bounds[stage] = tol
    if not (worst["attention_bwd"] <= 1.0 and worst["composite_tiles_bwd"] <= 1.0):
        raise AssertionError(f"tiny bf16 {name} train step: a backward kernel "
                             f"disagrees with its plain version on its inputs: {worst}")
    if not (got[0] <= tol[0] and got[1] <= tol[1] and tol[1] > 0):
        raise AssertionError(f"tiny bf16 {name} train step on the card disagrees "
                             "with the CPU")
    return launches


def run_train(dev, stage, conv="xla"):
    """A full-width train run on the card; returns the launch counts of its
    measured steps. Stage 1: AvatarConfig() defaults (Sapiens-1B geometry,
    frozen), bf16, B = 1, a 1024^2 reference view and 8 test views,
    train_stage1.yaml's optimizer (lr 5e-5, accumulate 4, clip 1.0): 1
    warm-up micro-step, then 8 (two accumulated updates); with a Winograd
    upsampler_conv `conv`, 1 warm-up and 2 micro-steps at accumulate 1 (each
    applies an update). Stage 2: the
    serving model's widths with the default render form (dense upsampler,
    tile splat), ted_speech.yaml's 1296x2304 frames, B = 2, T_in = 2,
    T_out = 6, train_stage2.yaml's lr 1e-4 and clip 1.0, both remat knobs on,
    through Stage2TrainLoop: 1 warm-up step and 2 with batch ids 1, 12 at
    replacement probability 1 (batch 12 reuses the cache batch 0 wrote). The
    frozen ViT one block deep (SHALLOW_VIT).
    Checks finite losses, moved trainable parameters, a bit-identical
    frozen ViT and the launches the configuration implies."""
    import dataclasses

    import torch
    from audio_motion_avatar_tpu_torch.data.synthetic import make_batch, to_device
    from audio_motion_avatar_tpu_torch.models.config import AvatarConfig
    from audio_motion_avatar_tpu_torch.ops import attention as at
    from audio_motion_avatar_tpu_torch.ops import splat_tiles as st
    from audio_motion_avatar_tpu_torch.ops import winograd as Wg
    from audio_motion_avatar_tpu_torch.train import STAGE1_OPTIM, STAGE2_OPTIM

    tag = f"train stage {stage}" + ("" if conv == "xla" else f", {conv}")
    if stage == 1 and conv != "xla":
        cfg, B, T_in, T_out = AvatarConfig(upsampler_conv=conv, vit_depth=SHALLOW_VIT), 1, 1, 8
        ids, optim, prob = [0] * 3, dataclasses.replace(STAGE1_OPTIM, accumulate_steps=1), 0.0
    elif stage == 1:
        cfg, B, T_in, T_out = AvatarConfig(vit_depth=SHALLOW_VIT), 1, 1, 8
        ids, optim, prob = [0] * 9, STAGE1_OPTIM, 0.0
    else:
        cfg, B, T_in, T_out = AvatarConfig(image_size=(1296, 2304), vit_depth=SHALLOW_VIT), 2, 2, 6
        ids, optim, prob = [0, 1, 12], STAGE2_OPTIM, 1.0
    H, W = cfg.image_size
    t0 = time.perf_counter()
    tr = seeded_trainer(stage, cfg, dev, torch.bfloat16, optim=optim, replacement_prob=prob)
    n_train = sum(p.numel() for p in tr.state.trainable.values())
    n_frozen = sum(p.numel() for p in tr.state.frozen.values())
    print(f"[{tag}] built in {time.perf_counter() - t0:.1f} s: {n_train / 1e6:.1f} M trainable, "
          f"{n_frozen / 1e9:.3f} G frozen parameters", flush=True)
    frozen = {k: p.detach().cpu() for k, p in tr.state.frozen.items()}
    watch = {k: p.detach().clone() for k, p in tr.state.trainable.items()
             if k.split(".")[-2].endswith("_layer") or "proj_out" in k}
    ref = to_device(make_batch(B, T_in, (H, W), seed=0), dev)
    if stage == 1:
        other = to_device(make_batch(B, T_out, (H, W), seed=1), dev)
    else:
        other = to_device(make_batch(B, T_out, (H, W), seed=1, with_audio=True,
                                     audio_dim=cfg.audio_feature_dim), dev)
    t0 = time.perf_counter()
    m = tr.step(ref, other, ids[0])
    torch.cuda.synchronize()
    print(f"[{tag}] warm-up step {1e3 * (time.perf_counter() - t0):.1f} ms, loss "
          f"{m['loss']:.5f}", flush=True)
    counters = (at.attention, at.attention_bwd, st.composite_tiles, st.composite_tiles_bwd,
                Wg.winograd_conv3x3, Wg.winograd_conv3x3_gn_relu)
    for fn in counters:
        fn.launches = 0
    st.composite_tiles.frames = 0
    torch.cuda.reset_peak_memory_stats(dev)
    times, metrics = [], []
    for bid in ids[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(tr.step(ref, other, bid))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {fn.__name__: fn.launches for fn in counters}
    frames = st.composite_tiles.frames
    peak = torch.cuda.max_memory_allocated(dev)
    per = train_launches(cfg, stage, B, T_in, T_out)
    expected = {k: v * len(times) for k, v in per.items()}
    print(f"[{tag}] launches {launches} expected {expected} ({per} a step); K1 composited "
          f"{frames / len(times):.1f} frames a step in its {launches['composite_tiles'] / len(times):.1f} "
          f"launches", flush=True)
    for i, (ms, mt) in enumerate(zip(times, metrics)):
        extra = f", cache_iter {mt['cache_iter']:.0f}" if stage == 2 else ""
        print(f"[{tag}] step {i}: {1e3 * ms:.1f} ms, loss {mt['loss']:.5f}, grad_norm "
              f"{mt['grad_norm']:.4f}{extra}", flush=True)
    mean_ms = 1e3 * sum(times) / len(times)
    moved = sum(not torch.equal(p, tr.state.trainable[k]) for k, p in watch.items())
    same = all(torch.equal(p.detach().cpu(), frozen[k]) for k, p in tr.state.frozen.items())
    print(f"[{tag}] {mean_ms:.1f} ms a step (mean of {len(times)}), peak memory "
          f"{peak / 2**30:.2f} GiB; {moved} of {len(watch)} watched trainable tensors moved; "
          f"frozen ViT bit-identical: {same}; updates applied {tr.state.opt.count}", flush=True)
    if launches != expected:
        raise AssertionError(f"{tag}: launches {launches} != {expected}")
    if not all(torch.isfinite(torch.tensor([mt["loss"], mt["grad_norm"]])).all()
               for mt in metrics):
        raise AssertionError(f"{tag}: non-finite loss or gradient norm")
    if moved == 0 or not same or tr.state.opt.count < 2:
        raise AssertionError(f"{tag}: trainable parameters did not move or the frozen ViT changed")
    if stage == 2 and [mt["cache_iter"] for mt in metrics] != [0.0, 1.0]:
        raise AssertionError(f"{tag}: the cache was not reused at batch 12")
    if stage == 1 and conv == "xla":
        eval_determinism(dev, tr)
    del tr
    torch.cuda.empty_cache()
    return launches, mean_ms, peak


DEMO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "demo")
PORT_CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "audio_motion_avatar_tpu_torch", "configs")


def demo_launches(cfg, n_chunks, B=2):
    """Kernel launches of main2's demo: the stage-1 token pass over B x T_in
    reference frames with the render off (kernel A in the ViT, the SMPL-X
    predictor and the fusion where their heads are 64 wide), then n_chunks
    rollouts of B x T_out frames, as phase 4 counts a request."""
    def wide(head_dim):
        return head_dim == 64

    stage1 = ((cfg.vit_depth if wide(cfg.image_feature_dim // cfg.vit_heads) else 0)
              + (2 * cfg.smplx_transformer_layers if wide(cfg.smplx_transformer_head_dim) else 0)
              + (2 * cfg.cross_transformer_layers if wide(cfg.cross_transformer_head_dim) else 0))
    chunks = B * cfg.triplane_output_frames // cfg.frames_per_chunk
    dec0 = cfg.ptv3_dec_depths[0] * chunks if not cfg.no_point_refiner and \
        wide(cfg.ptv3_dec_channels[0] // cfg.ptv3_dec_heads[0]) else 0
    audio = cfg.audio_transformer_layers * cfg.triplane_output_frames \
        if wide(cfg.audio_transformer_head_dim) else 0
    return {"attention": stage1 + n_chunks * (audio + dec0),
            "quad_rows": n_chunks * chunks, "composite_segments": n_chunks * chunks}


def demo_checkpoint(config, overrides, directory, visible=(1.0, 2.0), std=0.05, vit_depth=None):
    """Seeded weights made visible (perturbed heads, tamed token update,
    larger and more opaque gaussians) as the demo's checkpoint: the model
    main2 builds from this config, built on the CPU, saved by the port's
    CheckpointManager. vit_depth: build a shallower ViT (the frozen ViT is
    not in a checkpoint; the trainable tensors are the same)."""
    import dataclasses
    import shutil

    from audio_motion_avatar_tpu_torch import main2
    from audio_motion_avatar_tpu_torch.configs import ConfigLoader
    from audio_motion_avatar_tpu_torch.configs.build import (apply_serving_profile,
                                                             build_avatar_config)
    from audio_motion_avatar_tpu_torch.training.checkpoints import CheckpointManager
    from audio_motion_avatar_tpu_torch.weights import perturb_heads

    cfg = ConfigLoader.load_config(config, overrides)
    ac = apply_serving_profile(build_avatar_config(cfg), cfg)
    built = ac if vit_depth is None else dataclasses.replace(ac, vit_depth=vit_depth)
    roll = main2.build_stage2(cfg, built, "cpu")
    perturb_heads(roll.model, seed=1, std=std)
    tame_seeded_weights(roll.model)
    visible_heads(roll.model, *visible)
    shutil.rmtree(directory, ignore_errors=True)
    CheckpointManager(directory).save(0, main2.init_state2(roll.model, cfg))
    return ac


def wav2vec2_checkout(directory, seed=0):
    """A seeded Wav2Vec2-base checkout (config.json, pytorch_model.bin,
    preprocessor_config.json) the demo reads as a local wav2vec2-base-960h
    would be read; returns the model (CPU)."""
    import torch
    from audio_motion_avatar_tpu_torch.models.wav2vec2 import (Wav2Vec2ArchConfig,
                                                               Wav2Vec2Base)
    from audio_motion_avatar_tpu_torch.weights import init_weights
    arch = Wav2Vec2ArchConfig()
    model = Wav2Vec2Base(arch)
    init_weights(model, seed)
    os.makedirs(directory, exist_ok=True)
    torch.save(model.state_dict(), os.path.join(directory, "pytorch_model.bin"))
    conf = {k: list(v) if isinstance(v, tuple) else v for k, v in vars(arch).items()}
    conf.update(do_stable_layer_norm=False, feat_extract_norm="group")
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(directory, "preprocessor_config.json"), "w") as f:
        json.dump({"do_normalize": True}, f)
    return model.eval()


def demo_frames(out_dir):
    """The demo's written frames, decoded: (N, H, W, 3) float in [0, 1]."""
    import numpy as np
    import torch
    from audio_motion_avatar_tpu_torch.utils.video import read_png
    d = os.path.join(out_dir, "demo_outputs", "frames")
    frames = [read_png(os.path.join(d, n)) for n in sorted(os.listdir(d))]
    return torch.as_tensor(np.stack(frames).astype(np.float32) / 255.0)


def run_main2(argv):
    """main2.main(argv) with S, Q, A and K1 counted from 0 around it: (the
    demo's summary, its launches, its wall seconds)."""
    import torch
    from audio_motion_avatar_tpu_torch import main2
    from audio_motion_avatar_tpu_torch.ops import attention as at
    from audio_motion_avatar_tpu_torch.ops import splat_segmented as ss
    from audio_motion_avatar_tpu_torch.ops import splat_tiles as st
    from audio_motion_avatar_tpu_torch.ops import triplane as tp
    counters = (at.attention, tp.quad_rows, ss.composite_segments, st.composite_tiles)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    summary = main2.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return summary, {fn.__name__: fn.launches for fn in counters}, wall


def check_small_demo(dev):
    """12a: the tiny demo (config_tiny.yaml with its rendered-body data, 2
    chunks, seeded visible weights through the port's CheckpointManager) on
    the card and on the CPU: frames within mean|diff| <= 1e-3, the card's S,
    Q and K1 launches as the path implies (K1 renders the dataset's target
    videos); then a seeded Wav2Vec2-base window on the card against the CPU
    (fp32, TF32 off): max|diff| <= 1e-3 max|ref|, and its time."""
    import numpy as np
    import torch
    from audio_motion_avatar_tpu_torch.device import fp32_geometry
    from audio_motion_avatar_tpu_torch.models.wav2vec2 import zero_mean_unit_var

    config = os.path.join(PORT_CONFIGS, "config_tiny.yaml")
    over = ["dataset.render_gt=true", "dataset.length=14"]
    ckpt = os.path.join(DEMO_DIR, "tiny_ckpt")
    ac = demo_checkpoint(config, over, ckpt)
    runs = {}
    for d in (dev, "cpu"):
        out = os.path.join(DEMO_DIR, f"tiny_{torch.device(d).type}")
        runs[d] = run_main2(["--device", str(d), "--config", config, "--mode", "demo",
                             "--checkpoint", ckpt, f"training.output_dir={out}", *over])
        runs[d] = runs[d] + (demo_frames(out),)
    (summary, launches, wall, got), (_, _, cpu_wall, want) = runs[dev], runs["cpu"]
    n = summary["n_chunks"]
    expected = demo_launches(ac, n)
    # K1 renders each dataset item's reference and target videos: 2 items
    # for the token pass and 2 a chunk
    expected["composite_tiles"] = 2 * 2 * (n + 1)
    mad = (got - want).abs().reshape(got.shape[0], -1).mean(1)
    print(f"[small demo] tiny demo card {wall:.1f} s / CPU {cpu_wall:.1f} s, {got.shape[0]} "
          f"frames: mean|diff| max {float(mad.max()):.3e} (tol 1e-3); launches {launches} "
          f"expected {expected}", flush=True)
    if got.shape != want.shape or not (mad <= 1e-3).all():
        raise AssertionError("the tiny demo's frames on the card disagree with the CPU's")
    if launches != expected:
        raise AssertionError(f"tiny demo launches {launches} != {expected}")
    frames_ok(got[None], "small demo")

    model = wav2vec2_checkout(os.path.join(DEMO_DIR, "wav2vec2_small"), seed=3)
    wav = zero_mean_unit_var(np.random.RandomState(0).randn(int(round(8 / 24 * 16000))) * 0.1)
    x = torch.as_tensor(wav, dtype=torch.float32)[None]
    with torch.no_grad():
        ref = model(x)
        model.to(dev)
        with fp32_geometry():
            got = model(x.to(dev)).cpu()
            ms = time_ms(lambda: model(x.to(dev)), 10)
    err = float((got - ref).abs().max()) / float(ref.abs().max())
    print(f"[small demo] Wav2Vec2-base (12 x 768, seeded, fp32) one 8-frame window "
          f"{tuple(x.shape)} -> {tuple(ref.shape)}: card {ms:.2f} ms; max|diff| / max|ref| "
          f"{err:.3e} (tol 1e-3)", flush=True)
    if not err <= 1e-3:
        raise AssertionError("Wav2Vec2 on the card disagrees with the CPU")


def full_demo(dev):
    """12: main2 --mode demo at full width (config_stage_2.yaml, 512^2 synthetic
    data, B = 2, 1 chunk = 12 frames (2 chunks until the script's time
    limit cut it for phase 18), bf16), from a checkpoint of tamed
    seeded weights, a 16 kHz tone wav, a seeded Wav2Vec2-base checkout and
    the synthetic body in the released layout (release_body: its triangles
    join neighbours, as the released body's do, where the synthetic body's
    join random points and make the overlay ~7 times slower), all written
    under build/demo/. Checks the frames, the overlays, the
    losses and the launches; prints the time split, fps and peak memory."""
    import math

    import numpy as np
    import torch
    from audio_motion_avatar_tpu_torch.data.speech import write_wav

    config = os.path.join(PORT_CONFIGS, "config_stage_2.yaml")
    w2v = os.path.join(DEMO_DIR, "wav2vec2_base")
    body = os.path.join(DEMO_DIR, "SMPLX_NEUTRAL.npz")
    over = ["dataset.type=SyntheticDataset", "dataset.image_size=[512,512]",
            "dataset.length=2", f"dataset.wav2vec2_model_path={w2v}",
            "model.compute_dtype=bfloat16", f"model.triplane_net.smplx_model_path={body}",
            f"training.output_dir={DEMO_DIR}", CLI_VIT]
    t0 = time.perf_counter()
    release_body(body)
    ckpt = os.path.join(DEMO_DIR, "ckpt")
    ac = demo_checkpoint(config, over, ckpt, visible=(-1.0, 0.0), std=1e-2, vit_depth=1)
    wav2vec2_checkout(w2v)
    tone = os.path.join(DEMO_DIR, "tone.wav")
    t = np.arange(16000) / 16000.0
    write_wav(tone, 0.3 * np.sin(2 * np.pi * 220.0 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)))
    print(f"[demo] body, checkpoint, wav2vec2 checkout and tone written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    torch.cuda.reset_peak_memory_stats(dev)
    summary, launches, wall = run_main2(
        ["--config", config, "--mode", "demo", "--checkpoint", ckpt, "--audio", tone, *over])
    peak = torch.cuda.max_memory_allocated(dev)
    n = summary["n_chunks"]
    expected = demo_launches(ac, n)
    expected["composite_tiles"] = 0
    frames = demo_frames(DEMO_DIR)
    losses = [v for _, _, l1, sl in summary["losses"] for v in (l1, sl)]
    sec, chunks = summary["seconds"], summary["chunk_seconds"]
    per_chunk = 2 * ac.triplane_output_frames
    print(f"[demo] {summary['frames']} frames {tuple(frames.shape[1:])}, {summary['overlays']} "
          f"overlays drawn, {n} chunks; launches {launches} expected {expected}; losses "
          f"finite {all(math.isfinite(v) for v in losses)}; mp4 "
          f"{ {k: 'written' if v else 'skipped (no cv2)' for k, v in summary['mp4'].items()} }",
          flush=True)
    print(f"[demo] seconds: build {sec['build']:.2f}, data {sec['data']:.2f}, stage-1 tokens "
          f"{sec['stage-1 tokens']:.3f}, audio features {sec['audio features']:.3f}, rollouts "
          f"{', '.join(f'{c:.3f}' for c in chunks)} (first, then each), losses "
          f"{sec['losses']:.3f}, overlays {sec['overlays']:.2f} "
          f"({sec['overlays'] / summary['overlays']:.3f} a frame), writing {sec['writing']:.2f}; "
          f"main2.main wall {wall:.2f}", flush=True)
    print(f"[demo] fps: whole demo {summary['frames'] / wall:.3f}, after the build "
          f"{summary['frames'] / (wall - sec['build']):.3f}, rollouts "
          f"{summary['frames'] / sum(chunks):.2f} (without the first "
          f"{per_chunk * (len(chunks) - 1) / max(sum(chunks[1:]), 1e-9):.2f}); peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    if summary["frames"] != summary["overlays"] or summary["frames"] != 2 * n * \
            ac.triplane_output_frames or frames.shape[0] != summary["frames"]:
        raise AssertionError("the demo wrote the wrong number of frames or overlays")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite demo losses {summary['losses']}")
    if launches != expected:
        raise AssertionError(f"demo launches {launches} != {expected}")
    frames_ok(frames[None], "demo")
    return launches


CLI_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "cli")
CLI_COUNTERS = ("attention", "attention_bwd", "composite_tiles", "composite_tiles_bwd")


@contextlib.contextmanager
def counted():
    """K1, K2, A and A-bwd counted from 0 inside the block: yields the dict
    their launches are read into when it ends."""
    from audio_motion_avatar_tpu_torch.ops import attention as at
    from audio_motion_avatar_tpu_torch.ops import splat_tiles as st
    fns = (at.attention, at.attention_bwd, st.composite_tiles, st.composite_tiles_bwd)
    for fn in fns:
        fn.launches = 0
    out = {}
    yield out
    out.update({fn.__name__: fn.launches for fn in fns})


@contextlib.contextmanager
def vit_tokens(store, replay):
    """The Sapiens ViT's outputs of a run recorded into `store` (replay
    False), or replayed from it in order on the run's device (replay True):
    the ViT computes in bf16 whatever the config says and rounds differently
    on the card and the CPU, so the card's run is fed the CPU's tokens, as
    phase 9 feeds them."""
    from audio_motion_avatar_tpu_torch.models.image_encoder import SapiensEncoder
    orig = SapiensEncoder.forward
    queue = list(store)

    def forward(self, images):
        if replay:
            return queue.pop(0).to(images.device)
        out = orig(self, images)
        store.append(out.detach().cpu())
        return out

    SapiensEncoder.forward = forward
    try:
        yield
    finally:
        SapiensEncoder.forward = orig
    if replay and queue:
        raise AssertionError(f"{len(queue)} recorded ViT outputs were not replayed")


@contextlib.contextmanager
def host_seconds(cls, method, into, key):
    """Seconds spent in cls.method (summed into into[key], calls counted
    under key + ' calls') while the block runs."""
    orig = getattr(cls, method)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return orig(*args, **kwargs)
        finally:
            into[key] = into.get(key, 0.0) + time.perf_counter() - t0
            into[key + " calls"] = into.get(key + " calls", 0) + 1

    setattr(cls, method, timed)
    try:
        yield
    finally:
        setattr(cls, method, orig)


def forward_launches(cfg, stage, B, T_in, T_out=0, novel=False):
    """Launches of a forward without autograd: stage 1 renders the B x T_in
    reference frames (and, with novel, the test views in one more K1);
    stage 2 (the predict step) runs the stage-1 pass with the render off,
    then the rollout of B x T_out frames. No remat recompute."""
    def wide(head_dim):
        return head_dim == 64

    def chunks(frames):
        F = cfg.frames_per_chunk
        return frames // F if F > 0 and frames % F == 0 else frames

    stage1 = ((cfg.vit_depth if wide(cfg.image_feature_dim // cfg.vit_heads) else 0)
              + (2 * cfg.smplx_transformer_layers if wide(cfg.smplx_transformer_head_dim) else 0)
              + (2 * cfg.cross_transformer_layers if wide(cfg.cross_transformer_head_dim) else 0))
    dec0 = cfg.ptv3_dec_depths[0] if not cfg.no_point_refiner and \
        wide(cfg.ptv3_dec_channels[0] // cfg.ptv3_dec_heads[0]) else 0
    if stage == 1:
        ref = chunks(B * T_in)
        return {"attention": stage1 + dec0 * ref, "attention_bwd": 0,
                "composite_tiles": ref + int(novel), "composite_tiles_bwd": 0}
    audio = cfg.audio_transformer_layers * T_out if wide(cfg.audio_transformer_head_dim) else 0
    out = chunks(B * T_out)
    return {"attention": stage1 + audio + dec0 * out, "attention_bwd": 0,
            "composite_tiles": out, "composite_tiles_bwd": 0}


def add_launches(*parts):
    """Sum of {kernel: launches} dicts (each optionally times a count)."""
    total = {k: 0 for k in CLI_COUNTERS}
    for part, n in parts:
        for k in CLI_COUNTERS:
            total[k] += n * part[k]
    return total


def png_write(path, img):
    from audio_motion_avatar_tpu_torch.utils.images import encode_png
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(img))


def thuman_fixture(root, body, dev, subjects, views, size, render_size=None, seed=0):
    """A THuman-layout dataset written by the port (utils/images PNGs, calib
    JSON, smplx_param.pkl, vertices.npy): each subject a seeded pose of the
    synthetic body (global_orient 0 and transl (0, 0.35, 0), as the reader
    sets them; the renders place it at that transl) rendered by
    render_gt_video from `views` cameras orbiting it
    at render_size^2 (default: size, the config's), and train.txt / val.txt
    lists: subjects = (n_train, n_val) lists the first n_train subjects for
    training and the next n_val for validation (all of them when n_val is
    0). Returns the seconds it took."""
    import pickle
    import shutil

    import numpy as np
    import torch
    from audio_motion_avatar_tpu_torch.data.containers import VideoBatch
    from audio_motion_avatar_tpu_torch.data.synthetic import random_smpl_params, render_gt_video
    from audio_motion_avatar_tpu_torch.ops import smplx as smplx_ops
    from audio_motion_avatar_tpu_torch.ops.cameras import orbit_camera
    from audio_motion_avatar_tpu_torch.utils.video import to_uint8

    t0 = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    render_size = render_size or size
    names = [f"{i:04d}" for i in range(sum(subjects))]
    for i, subj in enumerate(names):
        rng = np.random.RandomState(seed + i)
        one = random_smpl_params(rng, (1, 1))
        one["global_orient"][:] = 0.0
        one["transl"][:] = (0.0, 0.35, 0.0)
        smpl = {k: np.repeat(v, views, axis=1) for k, v in one.items()}
        cams = [orbit_camera(angle=2 * np.pi * v / views + 0.3 * i, height=0.35,
                             focal=1.2 * render_size, image_size=(render_size, render_size))
                for v in range(views)]
        Ks, Es = (np.stack([c[j] for c in cams])[None] for j in (0, 1))
        placed = Es @ translation(one["transl"][0, 0])
        video = render_gt_video(body, VideoBatch(None, smpl, {"intrinsic": Ks,
                                                              "extrinsic": placed}),
                                (render_size, render_size), dev)[0]
        base = os.path.join(root, subj, "12views_3")
        os.makedirs(os.path.join(base, "calib"))
        for v in range(views):
            png_write(os.path.join(base, "render", f"{v:03d}.png"),
                      to_uint8(video[v].transpose(1, 2, 0)))
            with open(os.path.join(base, "calib", f"{v:03d}.json"), "w") as f:
                json.dump({"extrinsic": Es[0, v].tolist(), "intrinsic": Ks[0, v].tolist()}, f)
        verts = smplx_ops.forward(smplx_ops.as_tensors(body, "cpu"),
                                  {k: torch.as_tensor(v[:, 0]) for k, v in one.items()})
        np.save(os.path.join(base, "vertices.npy"), verts[0].numpy().astype(np.float32))
        os.makedirs(os.path.join(root, "smplx", subj))
        with open(os.path.join(root, "smplx", subj, "smplx_param.pkl"), "wb") as f:
            pickle.dump({k: v[0, 0].astype(np.float64) for k, v in one.items()}, f)
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(names[:subjects[0]]) + "\n")
    with open(os.path.join(root, "val.txt"), "w") as f:
        f.write("\n".join(names[subjects[0]:] or names) + "\n")
    return time.perf_counter() - t0


def translation(t):
    """The 4 x 4 that moves a point by t: render_gt_video poses the body
    without its transl, so a camera E sees the placed body through
    E @ translation(transl)."""
    import numpy as np
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = t
    return T



TED_DEPTH = 4.0     # the speaker's distance from the TED fixture's camera
# every full-width phase but the reconstruction (7, 7b: its latency counts
# the ViT), phase 17's stage-1 model (its seeded novel views went blank on
# the shallow ViT's tokens) and the kernel checks builds the frozen Sapiens
# ViT one block deep: the 40 blocks' seeded init took ~15 s of each build
# (the script's time limit); the ViT feeds the token pass, never a gradient
SHALLOW_VIT = 1
CLI_VIT = f"model.sapiens_encoder.vit_depth={SHALLOW_VIT}"


def ted_fixture(root, body, dev, frames, size, render_size=None, seed=0, chunk=6):
    """A TED-layout clip written by the port: `frames` frames of the
    synthetic body (a seeded pose a frame, TED_DEPTH units in front of an
    identity camera, K from focal 1.2 H and the centre) rendered by
    render_gt_video at render_size (default: size, the config's (H, W)),
    grey masks (the body's silhouette, soft-edged), SMPL-X JSONs and a 16 kHz
    wav of the clip's length. Returns the seconds it took."""
    import shutil

    import numpy as np
    from audio_motion_avatar_tpu_torch.data.containers import VideoBatch
    from audio_motion_avatar_tpu_torch.data.speech import write_wav
    from audio_motion_avatar_tpu_torch.data.synthetic import random_smpl_params, render_gt_video
    from audio_motion_avatar_tpu_torch.utils.video import to_uint8

    t0 = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    H, W = render_size or size
    focal, princpt = 1.2 * H, (W / 2.0, H / 2.0)
    K = np.array([[focal, 0, princpt[0]], [0, focal, princpt[1]], [0, 0, 1]], np.float32)
    smpl = random_smpl_params(np.random.RandomState(seed), (1, frames))
    smpl["transl"][:] = (0.0, 0.0, TED_DEPTH)
    keys = {"betas": "betas", "trans": "transl", "root_pose": "global_orient",
            "body_pose": "body_pose", "lhand_pose": "left_hand_pose",
            "rhand_pose": "right_hand_pose", "jaw_pose": "jaw_pose", "leye_pose": "leye_pose",
            "reye_pose": "reye_pose", "expression": "expression"}
    for c0 in range(0, frames, chunk):
        sl = slice(c0, min(frames, c0 + chunk))
        n = sl.stop - sl.start
        # the reader's camera is the identity; the speaker stands at transl
        cams = {"intrinsic": np.tile(K, (1, n, 1, 1)),
                "extrinsic": np.tile(translation((0.0, 0.0, TED_DEPTH)), (1, n, 1, 1))}
        video = render_gt_video(body, VideoBatch(None, {k: v[:, sl] for k, v in smpl.items()},
                                                 cams), (H, W), dev)[0]
        for j in range(n):
            i = c0 + j
            img = video[j].transpose(1, 2, 0)
            png_write(os.path.join(root, "imgs_png", f"{i:05d}.png"), to_uint8(img))
            mask = np.clip((1.0 - img.min(axis=-1)) * 8.0, 0.0, 1.0)
            png_write(os.path.join(root, "samurai_seg", f"{i:05d}.png"), to_uint8(mask))
            params = {jk: smpl[pk][0, i].tolist() for jk, pk in keys.items()}
            params.update(focal=[focal, focal], princpt=list(princpt))
            os.makedirs(os.path.join(root, "smplx_params"), exist_ok=True)
            with open(os.path.join(root, "smplx_params", f"{i:05d}.json"), "w") as f:
                json.dump(params, f)
    t = np.arange(int(16000 * frames / 24.0)) / 16000.0
    write_wav(os.path.join(root, "speech.wav"),
              0.3 * np.sin(2 * np.pi * 220.0 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)))
    return time.perf_counter() - t0


def logged_scalars(out):
    """(step, tag, value) of every event file under <out>/tb (the test run's
    trainer opens one too, without scalars)."""
    from audio_motion_avatar_tpu_torch.training.trainer import read_scalars
    tb = os.path.join(out, "tb")
    return [x for name in sorted(os.listdir(tb)) for x in read_scalars(os.path.join(tb, name))]


def close_rel(got, want, tol, floor):
    return abs(got - want) <= tol * max(abs(want), floor)


def check_small_cli(dev):
    """13a: the training CLIs at the tiny size, on the card and on the CPU
    (--device cpu), on fixtures the port writes: config_tiny.yaml, fp32.
    main.main --mode train (a THuman layout of 2 subjects x 4 views rendered
    at 48^2 and read at 32^2: one epoch of 2 micro-steps at accumulate 1,
    validation over both subjects, the monitored checkpoint), then --mode
    test from that checkpoint; main2.main --mode train (a TED layout of 18
    frames at 48 x 64 read at 32^2, batch 1: 2 steps, one epoch, the
    checkpoint), then --mode test from it. The card's run is fed the CPU
    run's ViT tokens (vit_tokens). Phase 9's rule for fp32: every logged
    train loss, validation metric and test metric of the card within 1e-4
    of the CPU's, relative (absolute below 1e-2 in magnitude). The card's
    K1, K2, A and A-bwd launches equal the count the config implies (A and
    A-bwd 0: the tiny heads are not 64 wide)."""
    import shutil

    import torch
    from audio_motion_avatar_tpu_torch import main as cli1
    from audio_motion_avatar_tpu_torch import main2 as cli2
    from audio_motion_avatar_tpu_torch.configs import ConfigLoader
    from audio_motion_avatar_tpu_torch.configs.build import build_avatar_config
    from audio_motion_avatar_tpu_torch.ops import smplx as smplx_ops

    config = os.path.join(PORT_CONFIGS, "config_tiny.yaml")
    body = smplx_ops.synthetic_model(seed=0, num_verts=400)
    thuman = os.path.join(CLI_DIR, "tiny_thuman")
    ted = os.path.join(CLI_DIR, "tiny_ted")
    thuman_fixture(thuman, body, "cpu", (2, 0), 4, 32, render_size=48)
    ted_fixture(ted, body, "cpu", 18, (32, 32), render_size=(48, 64))
    common = ["training.fast_dev_run=false", "training.max_epochs=1",
              "training.logging.log_every_n_steps=1", "dataset.image_size=[32,32]"]
    s1 = ["dataset.type=ThumanDataset", f"dataset.dataset_root={thuman}",
          f"dataset.smplx_params_path={thuman}/smplx", "dataset.n_test=3", "dataset.pcd_nums=50",
          "training.gradient_accumulate_steps=1", *common]
    s2 = ["dataset.type=GaussianAudioDataset", f"dataset.root_dir={ted}",
          "dataset.clip_length=8", "training.cache_replacement_prob=1.0", *common]
    runs, tokens = {}, []
    for d in ("cpu", dev):
        tag = torch.device(d).type
        out1 = os.path.join(CLI_DIR, f"tiny1_{tag}")
        shutil.rmtree(out1, ignore_errors=True)
        t0 = time.perf_counter()
        with vit_tokens(tokens, replay=tag != "cpu"), counted() as l1:
            cli1.main(["--device", str(d), "--config", config, "--mode", "train",
                       f"training.output_dir={out1}", *s1])
            m1 = cli1.main(["--device", str(d), "--config", config, "--mode", "test",
                            "--checkpoint", os.path.join(out1, "checkpoints"),
                            f"training.output_dir={out1}", *s1])
        logged = [(t, v) for _, t, v in logged_scalars(out1)
                  if t == "train/loss" or t.startswith("val/")]
        runs[tag] = {"stage 1 logged": logged, "stage 1 test": m1, "launches 1": l1,
                     "seconds 1": time.perf_counter() - t0}
    print(f"[small CLI] stage 1 (main train + test): CPU {runs['cpu']['seconds 1']:.1f} s, "
          f"card {runs['cuda']['seconds 1']:.1f} s", flush=True)

    tokens2 = []
    for d in ("cpu", dev):
        tag = torch.device(d).type
        out2 = os.path.join(CLI_DIR, f"tiny2_{tag}")
        shutil.rmtree(out2, ignore_errors=True)
        t0 = time.perf_counter()
        with vit_tokens(tokens2, replay=tag != "cpu"), counted() as l2:
            train = cli2.main(["--device", str(d), "--config", config, "--mode", "train",
                               f"training.output_dir={out2}", *s2])
            test = cli2.main(["--device", str(d), "--config", config, "--mode", "test",
                              "--checkpoint", os.path.join(out2, "checkpoints"),
                              f"training.output_dir={out2}", *s2])
        runs[tag].update({"stage 2 losses": [st["metrics"]["loss"] for st in train["steps"]],
                          "stage 2 test": test["l1"], "launches 2": l2,
                          "seconds 2": time.perf_counter() - t0})
    cpu, card = runs["cpu"], runs["cuda"]
    print(f"[small CLI] stage 2 (main2 train + test): CPU {cpu['seconds 2']:.1f} s, card "
          f"{card['seconds 2']:.1f} s", flush=True)

    pairs = [(f"stage 1 {t}", g, w) for (t, g), (_, w) in zip(card["stage 1 logged"],
                                                              cpu["stage 1 logged"])]
    pairs += [(f"stage 1 test {k}", card["stage 1 test"][k], v)
              for k, v in cpu["stage 1 test"].items()]
    pairs += [(f"stage 2 step {i} loss", g, w)
              for i, (g, w) in enumerate(zip(card["stage 2 losses"], cpu["stage 2 losses"]))]
    pairs.append(("stage 2 test l1", card["stage 2 test"], cpu["stage 2 test"]))
    worst = max(abs(g - w) / max(abs(w), 1e-2) for _, g, w in pairs)
    print(f"[small CLI] {len(pairs)} logged values card vs CPU: worst relative {worst:.3e} "
          f"(tol 1e-4); stage 1 train losses card "
          f"{[round(v, 6) for t, v in card['stage 1 logged'] if t == 'train/loss']} CPU "
          f"{[round(v, 6) for t, v in cpu['stage 1 logged'] if t == 'train/loss']}; stage 2 "
          f"losses card {[round(v, 6) for v in card['stage 2 losses']]} CPU "
          f"{[round(v, 6) for v in cpu['stage 2 losses']]}", flush=True)
    bad = [(n, g, w) for n, g, w in pairs if not close_rel(g, w, 1e-4, 1e-2)]
    if len(card["stage 1 logged"]) != len(cpu["stage 1 logged"]) or \
            len(card["stage 2 losses"]) != 2 or bad:
        raise AssertionError(f"the tiny CLIs on the card disagree with the CPU: {bad[:6]}")

    def cfg_of(over):
        return build_avatar_config(ConfigLoader.load_config(config, over))

    ac1, ac2 = cfg_of(s1), cfg_of(s2)
    n_views = 3 - 1    # n_test - 1 of the 4 views
    want1 = add_launches((train_launches(ac1, 1, 1, 1, n_views), 2),
                         (forward_launches(ac1, 1, 1, 1), 1),             # step 0's PNG
                         (forward_launches(ac1, 1, 1, 1, novel=True), 2 + 2),   # val + test
                         (forward_launches(ac1, 1, 1, 1), 2))             # test's PNGs
    want2 = add_launches((train_launches(ac2, 2, 1, 2, 6), 2),
                         (forward_launches(ac2, 2, 1, 2, 6), 2))
    print(f"[small CLI] card launches: stage 1 {card['launches 1']} expected {want1}; stage 2 "
          f"{card['launches 2']} expected {want2}", flush=True)
    if card["launches 1"] != want1 or card["launches 2"] != want2:
        raise AssertionError("the tiny CLIs' launches differ from what the config implies")


def cli_checkpoint(stage, config, over, directory):
    """Seeded weights as phases 10 and 11 make them (perturbed heads, made
    visible at full width; stage 2's token update tamed and its decoded body
    placed TED_DEPTH in front of the camera, as the TED fixture's), built on the CPU
    with a one-block ViT (the frozen ViT is not in a checkpoint) and saved
    by the port's CheckpointManager: the state the CLI's --checkpoint
    restores. Returns the saved trainable parameters (CPU)."""
    import dataclasses
    import shutil

    import torch
    from audio_motion_avatar_tpu_torch import main as cli1
    from audio_motion_avatar_tpu_torch import main2 as cli2
    from audio_motion_avatar_tpu_torch.configs import ConfigLoader
    from audio_motion_avatar_tpu_torch.configs.build import build_avatar_config
    from audio_motion_avatar_tpu_torch.models.avatar import TriplaneGaussianAvatar
    from audio_motion_avatar_tpu_torch.serve import num_verts_encoder
    from audio_motion_avatar_tpu_torch.training.checkpoints import CheckpointManager
    from audio_motion_avatar_tpu_torch.weights import init_weights, perturb_heads

    cfg = ConfigLoader.load_config(config, over)
    ac = dataclasses.replace(build_avatar_config(cfg), vit_depth=1)
    body = cli1.build_body(cfg, ac)
    if stage == 1:
        model = TriplaneGaussianAvatar(ac, num_verts_encoder(body))
        init_weights(model, 0)
        perturb_heads(model, seed=1, std=1e-2)
        visible_heads(model, scale_bias=-1.0, opacity_bias=0.0)
        state = cli1.init_state(model, cfg)
    else:
        model = cli2.build_stage2(cfg, ac, "cpu").model
        perturb_heads(model, seed=1, std=1e-2)
        tame_seeded_weights(model)
        visible_heads(model, scale_bias=-1.0, opacity_bias=0.0)
        # the decoded body where the TED clip's speaker stands: in front of
        # the identity camera
        with torch.no_grad():
            model.smpl_decoder.transl.bias.copy_(torch.tensor([0.0, 0.0, TED_DEPTH]))
        state = cli2.init_state2(model, cfg)
    shutil.rmtree(directory, ignore_errors=True)
    CheckpointManager(directory).save(0, state)
    return {k: p.detach().clone() for k, p in state.trainable.items()}


@contextlib.contextmanager
def built_models(module, name, model_of, into):
    """The models module.name builds while the block runs: (the model, its
    ViT's parameters as built, on the CPU) appended to `into`."""
    orig = getattr(module, name)

    def build(*args, **kwargs):
        out = orig(*args, **kwargs)
        model = model_of(out)
        into.append((model, vit_snapshot(model)))
        return out

    setattr(module, name, build)
    try:
        yield
    finally:
        setattr(module, name, orig)


def trained_checks(tag, model, start, vit_before, losses):
    """Finite losses, trainable parameters moved from the checkpoint the run
    started from, the frozen ViT bit-identical to its build."""
    import math

    import torch
    moved = sum(not torch.equal(p.detach().cpu(), start[k])
                for k, p in model.named_parameters() if k in start)
    vit = {k: p for k, p in model.named_parameters() if "sapiens_encoder" in k.split(".")}
    same = all(torch.equal(p.detach().cpu(), vit_before[k]) for k, p in vit.items())
    print(f"[{tag}] {moved} of {len(start)} trainable tensors moved from the checkpoint; frozen "
          f"ViT ({len(vit)} tensors) bit-identical: {same}; losses finite "
          f"{all(math.isfinite(v) for v in losses)}", flush=True)
    if not all(math.isfinite(v) for v in losses) or moved == 0 or not same or not vit:
        raise AssertionError(f"{tag}: non-finite losses, no parameter moved or the ViT changed")


def vit_snapshot(model):
    return {k: p.detach().cpu().clone() for k, p in model.named_parameters()
            if "sapiens_encoder" in k.split(".")}


def peak_memory(dev, reset=False):
    """Peak device memory since the last reset (0 off the card)."""
    import torch
    if torch.device(dev).type != "cuda":
        return 0
    if reset:
        torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.max_memory_allocated(dev)


def host_image_times(reps=3):
    """The host's seconds for one 1920 x 1080 RGB frame through
    utils/images: decode under each PNG row filter (every row the same
    filter, written by encode_png), the stage-2 reader's resize to 2304 x
    1296 and a 1024^2 -> 512^2 resize; the median of `reps`. A frame is a
    seeded smooth texture with noise."""
    import numpy as np
    from audio_motion_avatar_tpu_torch.utils import images

    rng = np.random.RandomState(0)
    y, x = np.mgrid[0:1080, 0:1920]
    frame = np.clip(np.stack([np.sin(x / (7.0 + k)) * 60 + np.cos(y / (5.0 + k)) * 50 + 120
                              for k in range(3)], -1) + rng.randint(-15, 15, (1080, 1920, 3)),
                    0, 255).astype(np.uint8)

    def median(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return sorted(times)[len(times) // 2]

    out = {}
    for kind, name in enumerate(("None", "Sub", "Up", "Average", "Paeth")):
        data = images.encode_png(frame, kind)
        if not np.array_equal(images.decode_png(data).pixels, frame):
            raise AssertionError(f"PNG decode under filter {name} does not round-trip")
        out[f"decode {name}"] = median(lambda: images.decode_png(data))
    out["resize to 2304 x 1296"] = median(lambda: images.resize(frame, (2304, 1296)))
    square = frame[:1024, :1024]
    out["resize 1024^2 -> 512^2"] = median(lambda: images.resize(square, (512, 512)))
    print("[host images] one 1920 x 1080 RGB frame, seconds (median of "
          f"{reps}): " + ", ".join(f"{k} {v:.4f}" for k, v in out.items()), flush=True)
    return out


def fingerprint(x):
    """A tensor's bits folded into two integers (position-weighted sums of
    its elements read as integers): equal bits give equal fingerprints."""
    import torch
    t = x.detach().contiguous()
    if t.dtype.is_floating_point:
        t = t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    t = t.reshape(-1).long()
    w = torch.arange(t.numel(), device=t.device) % 1009 + 1
    return int(t.sum()), int((t * w).sum())


@contextlib.contextmanager
def traced_outputs(model, into):
    """Every module's output in `model` and the outputs of the triplane
    segment ops (fingerprints, in the order they are computed) appended to
    `into` while the block runs."""
    import torch
    from audio_motion_avatar_tpu_torch.ops import triplane

    def record(name, out):
        flat = [out] if torch.is_tensor(out) else \
            [t for t in (out if isinstance(out, (tuple, list)) else getattr(out, "_asdict", dict)().values())
             if torch.is_tensor(t)]
        into.append((name, [fingerprint(t) for t in flat]))

    hooks = [m.register_forward_hook(lambda mod, args, out, n=n: record(n, out))
             for n, m in model.named_modules() if n]
    saved = {k: getattr(triplane, k) for k in ("scatter_mean_plane", "pool_local_max")}

    def wrap(k):
        def fn(*args, **kwargs):
            out = saved[k](*args, **kwargs)
            record(f"ops.triplane.{k}", out)
            return out
        return fn

    for k in saved:
        setattr(triplane, k, wrap(k))
    try:
        yield into
    finally:
        for h in hooks:
            h.remove()
        for k, fn in saved.items():
            setattr(triplane, k, fn)


def eval_determinism(dev, tr):
    """10c: the stage-1 evaluation of phase 10's model (AvatarConfig(), bf16,
    seeded weights, one 1024^2 reference view and 8 test views; `tr`, phase
    10's trainer after its steps), run twice on the same inputs. Prints
    whether the metrics and every module's and triplane segment op's output
    were the same bits both times, the first output that was not and the
    metrics' largest relative difference; fails unless they were the same."""
    from audio_motion_avatar_tpu_torch.data.synthetic import make_batch, to_device
    from audio_motion_avatar_tpu_torch.training import stage1

    tag = "eval determinism"
    model = tr.model.eval()
    ref = to_device(make_batch(1, 1, tr.cfg.image_size, seed=0), dev)
    test = to_device(make_batch(1, 8, tr.cfg.image_size, seed=1), dev)
    step = stage1.make_eval_step(model, tr.statics, tr.cfg)
    runs, metrics = [], []
    for _ in range(2):
        with traced_outputs(model, []) as out:
            metrics.append({k: float(v) for k, v in step(ref, test).items()})
        runs.append(out)
    first = next(((i, a[0]) for i, (a, b) in enumerate(zip(*runs)) if a != b), None)
    worst = max(abs(metrics[1][k] - v) / max(abs(v), 1e-12) for k, v in metrics[0].items())
    same = first is None and metrics[1] == metrics[0]
    print(f"[{tag}] 2 runs, {len(runs[0])} outputs traced a run; bit-identical {same}; first "
          f"differing output {first}; metrics' largest relative difference {worst:.3e}",
          flush=True)
    if not same:
        raise AssertionError(f"{tag}: the stage-1 evaluation did not repeat bit for bit")


def cli_train_stage1(dev, phase10_ms, size=1024, extra=()):
    """13: `main.main --mode train` at full width: config_stage_1.yaml with
    model.compute_dtype=bfloat16 and the THuman reader on a fixture under
    build/cli/ (8 train and 2 val subjects, 12 views each rendered at 1024^2
    from the synthetic body), from a checkpoint of phase 10's seeded weights:
    max_epochs=1, so 8 micro-steps at accumulate 4 (two updates), then the
    validation and the monitored checkpoint; then `main.main --mode test
    --checkpoint <out>/checkpoints`, whose metrics must equal the fit's
    final validation (the same weights and val split) within 1e-5 of
    max(|value|, 1e-3): the evaluation repeats bit for bit in one process
    (10c) since the triplane segment mean sums in a fixed order; the
    two runs, in two builds of the model, differed by up to 6e-8 of a
    value (PERF.md; by up to 7e-4 while the mean was an atomic
    scatter-add, when the bound was one bf16 unit). Checks finite
    losses, moved trainable parameters, a bit-identical ViT, the event files,
    the comparison PNGs and config.yaml, and K1 / K2 / A / A-bwd launches as
    the config implies; prints the ms of a micro-step through the CLI
    (step_time_s, from before the step to its metrics read back) beside phase
    10's, the host's seconds a step in the reader (PNG decode and resize
    apart) and the peak memory. size and extra (overrides after the
    phase's) rehearse it small (e.g. profile=tiny on the CPU)."""
    import torch
    from audio_motion_avatar_tpu_torch import main as cli1
    from audio_motion_avatar_tpu_torch.configs import ConfigLoader
    from audio_motion_avatar_tpu_torch.configs.build import build_avatar_config
    from audio_motion_avatar_tpu_torch.data import thuman
    from audio_motion_avatar_tpu_torch.ops import smplx as smplx_ops

    tag = "train CLI, stage 1"
    host_image_times()
    config = os.path.join(PORT_CONFIGS, "config_stage_1.yaml")
    root, out = os.path.join(CLI_DIR, "thuman"), os.path.join(CLI_DIR, "stage1")
    body = smplx_ops.synthetic_model(seed=0)
    fixture_s = thuman_fixture(root, body, dev, (8, 2), 12, size)
    over = ["model.compute_dtype=bfloat16", f"dataset.dataset_root={root}",
            f"dataset.smplx_params_path={root}/smplx", f"dataset.train_list={root}/train.txt",
            f"dataset.val_list={root}/val.txt", "training.max_epochs=1",
            "training.logging.log_every_n_steps=1", f"training.output_dir={out}", CLI_VIT,
            *extra]
    t0 = time.perf_counter()
    ckpt = os.path.join(CLI_DIR, "stage1_ckpt")
    start = cli_checkpoint(1, config, over, ckpt)
    print(f"[{tag}] fixture (10 subjects x 12 views at {size}^2) {fixture_s:.1f} s, seeded "
          f"checkpoint {time.perf_counter() - t0:.1f} s", flush=True)
    import shutil
    shutil.rmtree(out, ignore_errors=True)

    host, models = {}, []
    peak_memory(dev, reset=True)
    t0 = time.perf_counter()
    with counted() as fit_launches, \
            built_models(cli1, "build_everything", lambda out: out[0], models), \
            host_seconds(thuman.ThumanDataset, "__getitem__", host, "items"), \
            host_seconds(thuman, "load_image", host, "decode + resize"):
        cli1.main(["--device", str(dev), "--config", config, "--mode", "train",
                   "--checkpoint", ckpt, *over])
    fit_s = time.perf_counter() - t0
    peak = peak_memory(dev)
    model, vit_before = models[0]
    scalars = logged_scalars(out)
    losses = [v for _, t, v in scalars if t == "train/loss"]
    step_ms = [1e3 * v for _, t, v in scalars if t == "train/step_time_s"]
    val = {t[4:]: v for _, t, v in scalars if t.startswith("val/")}
    trained_checks(tag, model, start, vit_before, losses)
    del models[:], model, vit_before
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with counted() as test_launches:
        metrics = cli1.main(["--device", str(dev), "--config", config, "--mode", "test",
                             "--checkpoint", os.path.join(out, "checkpoints"), *over])
    test_s = time.perf_counter() - t0
    ac = build_avatar_config(ConfigLoader.load_config(config, over))
    n_views, n_val = 7, 2
    want_fit = add_launches((train_launches(ac, 1, 1, 1, n_views), 8),
                            (forward_launches(ac, 1, 1, 1), 1),
                            (forward_launches(ac, 1, 1, 1, novel=True), n_val))
    want_test = add_launches((forward_launches(ac, 1, 1, 1, novel=True), n_val),
                             (forward_launches(ac, 1, 1, 1), n_val))
    items = host.get("items calls", 0)
    print(f"[{tag}] main.main train {fit_s:.1f} s ({len(losses)} micro-steps, test {test_s:.1f} "
          f"s); losses {[round(v, 5) for v in losses]}; ms a micro-step through the CLI "
          f"{[round(v, 1) for v in step_ms]} (mean {sum(step_ms) / len(step_ms):.1f}; phase 10 "
          f"{phase10_ms:.1f}); the reader {host['items'] / items:.3f} s an item (8 views at "
          f"{size}^2), of it PNG decode + resize {host['decode + resize'] / items:.3f} s "
          f"({host['decode + resize calls']} images, "
          f"{host['decode + resize'] / host['decode + resize calls']:.4f} s each); peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    print(f"[{tag}] launches: fit {fit_launches} expected {want_fit}; test {test_launches} "
          f"expected {want_test}", flush=True)
    ratio = {k: abs(metrics[k] - v) / (1e-5 * max(abs(v), 1e-3)) for k, v in val.items()}
    rel = max(abs(metrics[k] - v) / max(abs(v), 1e-12) for k, v in val.items())
    print(f"[{tag}] test metrics against the fit's validation: worst |diff| / bound "
          f"{max(ratio.values()):.3f} ({max(ratio, key=ratio.get)}; bound 1e-5 max(|v|, 1e-3)), "
          f"largest relative difference {rel:.3e}; loss {metrics['loss']:.6f} vs "
          f"{val['loss']:.6f}", flush=True)
    print(f"[{tag}] each metric, test / validation / |diff|: " + ", ".join(
        f"{k} {metrics[k]:.7g} / {v:.7g} / {abs(metrics[k] - v):.3e}" for k, v in sorted(val.items())),
        flush=True)
    files = [os.path.join(out, p) for p in ("config.yaml", "train_images/comparison_0.png",
                                            "test_images/triplane_comparison_0.png")]
    if len(losses) != 8 or sorted(metrics) != sorted(val) or max(ratio.values()) > 1.0:
        raise AssertionError(f"{tag}: the test metrics differ from the fit's validation")
    if not all(os.path.exists(f) for f in files) or os.listdir(os.path.join(out, "checkpoints")) \
            != ["8"]:
        raise AssertionError(f"{tag}: an output is missing")
    if fit_launches != want_fit or test_launches != want_test:
        raise AssertionError(f"{tag}: launches differ from what the config implies")
    return fit_launches


def cli_train_stage2(dev, phase11_ms, size=(1296, 2304), extra=()):
    """14: `main2.main --mode train` at full width: config_stage_2.yaml with
    model.compute_dtype=bfloat16 and the TED reader on a clip under
    build/cli/ (22 frames of the synthetic body at 1296 x 2304 with grey
    masks, SMPL-X JSONs, a 16 kHz wav; dataset.wav2vec2_model_path a seeded
    Wav2Vec2-base checkout), from a checkpoint of phase 11's seeded weights:
    batch 2, one epoch of 2 steps (batch ids 0, 2) at
    cache_replacement_prob 1 (each step puts its prediction in the cache;
    none reads one: phase 11 takes the cache through Stage2TrainLoop, and
    the script's time limit cut this fit from 7 steps on 42 frames); then
    `main2.main --mode test` from the written checkpoint on the clip (4
    items, B = 1). Its first step is phase 18(a)'s one-process side. Checks
    finite losses, moved trainable
    parameters, a bit-identical ViT, the event files, the comparison PNGs,
    the cache depth of each step and K1 / K2 / A / A-bwd launches as the
    config implies; prints the ms of a step through the CLI (to its metrics
    read back) beside phase 11's, the host's seconds a step in the reader
    (decode, composite and resize apart) and the peak memory. size and
    extra rehearse it small, as in phase 13. Returns its launches, the wall
    a step (batch hand-off to hand-off), the step's own ms, the reader's
    seconds an item and the first step's metrics, for phases 14b and 18."""
    import shutil

    import torch
    from audio_motion_avatar_tpu_torch import main2 as cli2
    from audio_motion_avatar_tpu_torch.configs import ConfigLoader
    from audio_motion_avatar_tpu_torch.configs.build import build_avatar_config
    from audio_motion_avatar_tpu_torch.data import speech
    from audio_motion_avatar_tpu_torch.ops import smplx as smplx_ops

    tag = "train CLI, stage 2"
    config = os.path.join(PORT_CONFIGS, "config_stage_2.yaml")
    root, out = os.path.join(CLI_DIR, "ted"), os.path.join(CLI_DIR, "stage2")
    w2v = os.path.join(DEMO_DIR, "wav2vec2_base")
    if not os.path.exists(os.path.join(w2v, "pytorch_model.bin")):
        wav2vec2_checkout(w2v)
    fixture_s = ted_fixture(root, smplx_ops.synthetic_model(seed=0), dev, 22, size)
    over = ["model.compute_dtype=bfloat16", f"dataset.root_dir={root}",
            f"dataset.wav2vec2_model_path={w2v}", "training.max_epochs=1",
            "training.cache_replacement_prob=1.0", "training.logging.log_every_n_steps=1",
            f"training.output_dir={out}", CLI_VIT, *extra]
    t0 = time.perf_counter()
    ckpt = os.path.join(CLI_DIR, "stage2_ckpt")
    start = cli_checkpoint(2, config, over, ckpt)
    print(f"[{tag}] fixture (22 frames at {size[0]} x {size[1]}) {fixture_s:.1f} s, seeded checkpoint "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    shutil.rmtree(out, ignore_errors=True)

    host, built, seen, rolls = {}, [], {}, []
    peak_memory(dev, reset=True)
    t0 = time.perf_counter()
    with counted() as fit_launches, train_handoffs(seen), \
            built_models(cli2, "build_stage2", lambda roll: rolls.append(roll) or roll.model,
                         built), \
            host_seconds(speech.GaussianAudioDataset, "__getitem__", host, "items"), \
            host_seconds(speech.GaussianAudioDataset, "_load_frame", host, "frames"):
        summary = cli2.main(["--device", str(dev), "--config", config, "--mode", "train",
                             "--checkpoint", ckpt, *over])
    fit_s = time.perf_counter() - t0
    peak = peak_memory(dev)
    model, vit_before = built[0]
    steps = summary["steps"]
    losses = [st["metrics"]["loss"] for st in steps]
    depths = [st["cache_iter"] for st in steps]
    step_ms = [1e3 * st["seconds"] for st in steps]
    trained_checks(tag, model, start, vit_before, losses)
    logged = [v for _, t, v in logged_scalars(out) if t == "train/loss"]
    rowwise = first_batch_losses(rolls[0], start, ConfigLoader.load_config(config, over), dev)
    print(f"[{tag}] the first batch's loss on the starting weights, forward only: as one "
          f"batch of 2 {rowwise[0]:.6f} (the step's {losses[0]:.6f}), as 2 batches of 1 "
          f"{rowwise[1]:.6f} (relative {abs(rowwise[1] - rowwise[0]) / abs(rowwise[0]):.3e}: "
          f"phase 18(a)'s bound is 3x this)", flush=True)
    del built[:], model, vit_before, rolls[:]
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with counted() as test_launches:
        test = cli2.main(["--device", str(dev), "--config", config, "--mode", "test",
                          "--checkpoint", os.path.join(out, "checkpoints"), *over])
    test_s = time.perf_counter() - t0
    ac = build_avatar_config(ConfigLoader.load_config(config, over))
    want_fit = add_launches((train_launches(ac, 2, 2, 2, 6), len(steps)))
    want_test = add_launches((forward_launches(ac, 2, 1, 2, 6), test["batches"]))
    items = host["items calls"]
    print(f"[{tag}] main2.main train {fit_s:.1f} s ({len(steps)} steps, test {test_s:.1f} s over "
          f"{test['batches']} items, l1 {test['l1']:.5f}); losses {[round(v, 5) for v in losses]}; "
          f"cache depth a step {depths}; ms a step through the CLI "
          f"{[round(v, 1) for v in step_ms]} (mean {sum(step_ms) / len(step_ms):.1f}, without the "
          f"first {sum(step_ms[1:]) / max(len(step_ms) - 1, 1):.1f}; phase 11 {phase11_ms:.1f}); "
          f"the reader {host['items'] / items:.3f} s an item (8 frames), "
          f"{2 * host['items'] / items:.3f} s a step of 2, of it decode + composite + resize "
          f"{host['frames'] / host['frames calls']:.4f} s a frame; wall a step (batch hand-off "
          f"to hand-off) {1e3 * wall_per_step(seen['times']):.1f} ms; peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    print(f"[{tag}] launches: fit {fit_launches} expected {want_fit}; test {test_launches} "
          f"expected {want_test}", flush=True)
    images = os.path.join(out, "audio_rendered_images")
    files = [os.path.join(images, "audio_comparison_0_iter0.png"),
             os.path.join(images, "ref_comparison_0.png")] + \
        [os.path.join(out, "predict_results", f"audio_comparison_{n}.png") for n in range(4)]
    if len(steps) != 2 or depths != [0, 0] or \
            [round(v, 4) for v in logged] != [round(v, 4) for v in losses]:
        raise AssertionError(f"{tag}: steps {len(steps)}, cache depths {depths}, logged losses "
                             f"{logged}")
    if not all(os.path.exists(f) for f in files) or \
            os.listdir(os.path.join(out, "checkpoints")) != ["2"]:
        raise AssertionError(f"{tag}: an output is missing")
    if not test["batches"] == 4 or not test["l1"] == test["l1"]:
        raise AssertionError(f"{tag}: the test run {test}")
    if fit_launches != want_fit or test_launches != want_test:
        raise AssertionError(f"{tag}: launches differ from what the config implies")
    return {"launches": fit_launches, "wall": wall_per_step(seen["times"]),
            "step": sum(step_ms[1:]) / max(len(step_ms) - 1, 1),
            "item": host["items"] / items, "first": steps[0]["metrics"],
            "rowwise": rowwise}


def first_batch_losses(roll, start, cfg, dev):
    """The stage-2 loss of the train split's first global batch (items 0
    and 1) on the trainable weights `start`, without autograd and without
    the cache: (as one batch of 2, the mean of the two rows as batches of
    1). The two differ only by the card's bf16 rounding of differently
    shaped products, the difference two data ranks make; the second is
    what two data ranks compute."""
    import torch
    from audio_motion_avatar_tpu_torch.data.containers import collate_video_batches
    from audio_motion_avatar_tpu_torch.data.factory import DatasetFactory
    from audio_motion_avatar_tpu_torch.data.synthetic import to_device
    from audio_motion_avatar_tpu_torch.training import stage2

    model = roll.model
    with torch.no_grad():
        for k, p in model.named_parameters():
            if k in start:
                p.copy_(start[k])
    ds = DatasetFactory.create_dataset(cfg, "train", dev)
    items = [ds[0], ds[1]]

    def loss(rows):
        ref = to_device(collate_video_batches([items[i][0] for i in rows]), dev)
        tgt = to_device(collate_video_batches([items[i][1] for i in rows]), dev)
        tri, smpl = stage2._zero_tokens(model.cfg, len(rows), dev)
        with torch.no_grad():
            return float(stage2.stage2_loss(model, roll.statics, ref, tgt, tri, smpl,
                                            torch.zeros(len(rows), device=dev),
                                            model.cfg)[0])

    return loss([0, 1]), (loss([0]) + loss([1])) / 2


@contextlib.contextmanager
def train_handoffs(into):
    """While the block runs, the train split's loader (DatasetFactory.
    create_dataloader's) records into["times"] the moment it hands each batch
    to the step loop, into["items"] the ids of the items a prefetcher hands
    on and into["ring"] the prefetcher's ring ("none" without one) and
    into["error"] why it is not the native one."""
    from audio_motion_avatar_tpu_torch.data import factory, prefetch

    orig, orig_iter = factory.DatasetFactory.create_dataloader, prefetch.NativePrefetcher.__iter__
    into.update(times=[], items=[], ring="none")

    def create(cfg, split="train", device="cpu", **kw):
        loader = orig(cfg, split, device, **kw)
        if split != "train":
            return loader
        pf = loader.dataset if hasattr(loader, "batch_size") else loader
        into["ring"], into["error"] = getattr(pf, "ring", "none"), getattr(pf, "error", None)

        def timed():
            for batch in loader:
                into["times"].append(time.perf_counter())
                yield batch
        return timed()

    def items(self):
        for item in orig_iter(self):
            into["items"].append(item[2])
            yield item

    factory.DatasetFactory.create_dataloader = staticmethod(create)
    prefetch.NativePrefetcher.__iter__ = items
    try:
        yield into
    finally:
        factory.DatasetFactory.create_dataloader = staticmethod(orig)
        prefetch.NativePrefetcher.__iter__ = orig_iter


def wall_per_step(times):
    """Seconds from one batch's hand-off to the next, averaged: a step and
    the wait for the next batch."""
    return (times[-1] - times[0]) / max(len(times) - 1, 1)


def cli_train_stage2_workers(dev, phase14, size=(1296, 2304), extra=()):
    """14b: phase 14's fit again (its checkpoint and overrides) with
    training.dataloader.num_workers=4, on the clip (22 frames, 4 items, 2
    steps): the TED reader's items come
    through the prefetch ring's 4 threads, ahead of the steps, in the order
    they complete. Checks that the native ring ran (built with g++ from
    csrc/prefetch.cpp), that every item of the clip was handed on exactly
    once, the steps' count, finite losses and the launches; prints the wall
    per step (batch hand-off to hand-off) beside phase 14's and the step's
    own time. Losses are not compared: the batches differ in order."""
    import math
    import shutil

    from audio_motion_avatar_tpu_torch import main2 as cli2
    from audio_motion_avatar_tpu_torch.configs import ConfigLoader
    from audio_motion_avatar_tpu_torch.configs.build import build_avatar_config
    from audio_motion_avatar_tpu_torch.data import prefetch, speech

    tag = "train CLI, stage 2, workers"
    config = os.path.join(PORT_CONFIGS, "config_stage_2.yaml")
    root, out = os.path.join(CLI_DIR, "ted"), os.path.join(CLI_DIR, "stage2_workers")
    over = ["model.compute_dtype=bfloat16", f"dataset.root_dir={root}",
            f"dataset.wav2vec2_model_path={os.path.join(DEMO_DIR, 'wav2vec2_base')}",
            "training.max_epochs=1", "training.cache_replacement_prob=1.0",
            "training.logging.log_every_n_steps=1", f"training.output_dir={out}",
            "training.dataloader.num_workers=4", CLI_VIT, *extra]
    shutil.rmtree(out, ignore_errors=True)
    host, seen = {}, {}
    peak_memory(dev, reset=True)
    t0 = time.perf_counter()
    with counted() as launches, train_handoffs(seen), \
            host_seconds(speech.GaussianAudioDataset, "__getitem__", host, "items"):
        summary = cli2.main(["--device", str(dev), "--config", config, "--mode", "train",
                             "--checkpoint", os.path.join(CLI_DIR, "stage2_ckpt"), *over])
    fit_s = time.perf_counter() - t0
    peak = peak_memory(dev)
    steps = summary["steps"]
    step_ms = [1e3 * st["seconds"] for st in steps]
    wall = wall_per_step(seen["times"])
    n_items = host["items calls"]
    ac = build_avatar_config(ConfigLoader.load_config(config, over))
    want = add_launches((train_launches(ac, 2, 2, 2, 6), len(steps)))
    print(f"[{tag}] main2.main train {fit_s:.1f} s ({len(steps)} steps), ring "
          f"{seen['ring']!r} ({prefetch.lib_path() if seen['ring'] == 'native' else seen['error']}); "
          f"wall a step (batch hand-off to hand-off) {1e3 * wall:.1f} ms against phase 14's "
          f"{1e3 * phase14['wall']:.1f} ms ({wall / phase14['wall']:.3f}); the step itself "
          f"{sum(step_ms[1:]) / max(len(step_ms) - 1, 1):.1f} ms without the first (phase 14 "
          f"{phase14['step']:.1f}); the reader {host['items'] / n_items:.3f} s an item on the "
          f"ring's threads (phase 14, in the loop: {phase14['item']:.3f}); items handed on "
          f"{sorted(seen['items'])}; peak memory {peak / 2**30:.2f} GiB", flush=True)
    print(f"[{tag}] launches {launches} expected {want}", flush=True)
    if seen["ring"] != "native":
        raise AssertionError(f"{tag}: the prefetch ring ran {seen['ring']!r}: {seen['error']}")
    if sorted(seen["items"]) != list(range(n_items)) or n_items != 2 * len(steps) or \
            len(steps) != 2:
        raise AssertionError(f"{tag}: items {sorted(seen['items'])} of {n_items}, {len(steps)} steps")
    if not all(math.isfinite(st["metrics"]["loss"]) for st in steps):
        raise AssertionError(f"{tag}: non-finite losses")
    if launches != want:
        raise AssertionError(f"{tag}: launches differ from what the config implies")
    return launches


IMPORT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "import")
MANIFEST = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                        "ted_full_ckpt.manifest.json")
SMPLX_FACES = 20908


def release_body(path, num_faces=SMPLX_FACES):
    """The synthetic SMPL-X (seed 0, 10475 vertices) with the released
    model's face count, written in the released .npz layout that
    ops/smplx.load_model reads: its vertices ordered into height bands by
    azimuth so that the grid's faces join neighbours (the released body's
    triangles are small too; the synthetic body's join random points, which
    makes the demo's overlay slow), the grid's faces then trimmed or
    repeated to num_faces (as the JAX package's synthetic_model(num_faces)
    does). Returns the body as load_model reads it."""
    import numpy as np
    from audio_motion_avatar_tpu_torch.ops import smplx as smplx_ops

    m = smplx_ops.synthetic_model(seed=0)
    V = m.v_template.shape[0]
    rows = int(np.floor(np.sqrt(V)))
    cols = V // rows
    by_height = np.argsort(m.v_template[:, 1], kind="stable")
    bands = [b[np.argsort(np.arctan2(m.v_template[b, 2], m.v_template[b, 0]), kind="stable")]
             for b in by_height[:rows * cols].reshape(rows, cols)]
    order = np.concatenate(bands + [by_height[rows * cols:]])
    faces = smplx_ops._grid_faces(rows, cols)
    faces = np.tile(faces, (-(-num_faces // len(faces)), 1))[:num_faces]
    P = m.posedirs.shape[0]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, v_template=m.v_template[order],
             shapedirs=np.concatenate([m.shapedirs, m.exprdirs], -1)[order],
             posedirs=m.posedirs.reshape(P, V, 3)[:, order].transpose(1, 2, 0),
             J_regressor=m.J_regressor[:, order], weights=m.lbs_weights[order],
             kintree_table=np.stack([m.parents, np.arange(len(m.parents))]), f=faces)
    return smplx_ops.load_model(path)


def reference_checkpoint(path, manifest, seed=0):
    """A Lightning-style .ckpt (epoch, global_step, a plain-dict
    hyper_parameters, state_dict) of the reference's tensor names and
    shapes in `manifest`, drawn as the port's seeded init draws
    (weights.init_weights): weights ~ N(0, 1 / fan_in), biases 0, norm
    scales 1, BatchNorm running means 0 and variances 1, then the
    reference head init (renderer.reset_heads: zero head kernels, rotation
    bias [1, 0, 0, 0], the refiner's offset layer zero); then, in the
    reference's names, what the demo phases do to seeded weights: the heads'
    kernels perturbed by N(0, 1e-2) (perturb_heads), tame_seeded_weights (the
    token update and the decoded translation and root rotation damped) and
    visible_heads(-1, 0) (the position, scale and opacity kernels zeroed,
    their biases set). Returns the state dict (numpy) and the seconds it
    took to write."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, shape in sorted(manifest.items()):
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            sd[name] = torch.zeros((), dtype=torch.int64)
        elif leaf in ("running_mean",) or leaf.endswith("bias"):
            sd[name] = torch.zeros(shape)
        elif leaf == "running_var" or len(shape) == 1:
            sd[name] = torch.ones(shape)
        else:
            sd[name] = torch.randn(shape, generator=g) / float(np.prod(shape[1:])) ** 0.5
    dec, heads = "triplane_gaussian.smplx_decoder", "triplane_gaussian.renderer.gaussian_decoder"
    offsets = "triplane_gaussian.renderer.point_refiner.4"
    noise = torch.Generator().manual_seed(seed + 1)
    tame = {f"{offsets}.weight": torch.zeros_like, f"{offsets}.bias": torch.zeros_like,
            f"{heads}.rotation_layer.bias": lambda b: torch.tensor([1.0, 0, 0, 0]),
            "audio_triplane.transformer.proj_out.weight": lambda w: w * 0.01,
            f"{dec}.dec_transl.weight": lambda w: w * 0.01,
            f"{dec}.dec_transl.bias": lambda b: b * 0.0,
            f"{dec}.dec_body_root_pose.weight": lambda w: w * 0.01,
            f"{dec}.dec_body_root_pose.bias": lambda b: torch.tensor([1.0, 0, 0, 0, 1, 0]),
            f"{heads}.scaling_layer.bias": lambda b: torch.full_like(b, -1.0),
            f"{heads}.opacity_layer.bias": lambda b: torch.full_like(b, 0.0)}
    for name in ("rotation_layer", "shs_layer"):
        tame[f"{heads}.{name}.weight"] = \
            lambda w: 1e-2 * torch.randn(w.shape, generator=noise)
    for name in ("xyz_layer", "scaling_layer", "opacity_layer"):
        tame[f"{heads}.{name}.weight"] = torch.zeros_like
    for k, fn in tame.items():
        if k in sd:
            sd[k] = fn(sd[k])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"epoch": 0, "global_step": 0, "hyper_parameters": {"lr": 1e-4, "stage": 2},
                "state_dict": sd}, path)
    return {k: v.numpy() for k, v in sd.items()}, time.perf_counter() - t0


def import_demo(dev, manifest=None, extra=()):
    """15: `main2.main --mode demo --checkpoint FILE` at full width: phase
    12's demo (config_stage_2.yaml, the synthetic dataset at 512^2, 1
    chunk of B = 2 x 6 frames (2 until phase 18's cut), bf16, the tone and the seeded
    Wav2Vec2-base) from a reference Lightning .ckpt of the released stage-2
    checkpoint's 649 tensors (tests/fixtures/ted_full_ckpt.manifest.json,
    seeded by reference_checkpoint), on the synthetic body with the
    released face count (release_body: vertex_emb's 31383 rows), both
    written under build/import/, with model.triplane_net.sample_feature=true
    (the manifest's encoder samples image features: its vertex_emb is 128
    wide, where config_stage_2.yaml's setting makes it 256). Checks the import (0 mismatches; the
    loaded count and skipped modules of the port's CPU dry run over the
    same tensors), the upsampler norm defaulted to 'affine', frames written
    and not blank, finite losses and the launches; prints the import's
    seconds, the rollouts' fps and the peak memory. manifest and extra
    (overrides after the phase's) rehearse it small."""
    import json
    import math

    import numpy as np
    import torch
    from audio_motion_avatar_tpu_torch.configs import ConfigLoader
    from audio_motion_avatar_tpu_torch.configs.build import (apply_serving_profile,
                                                             build_avatar_config,
                                                             default_affine_norm_for_import)
    from audio_motion_avatar_tpu_torch.training import torch_import

    tag = "import demo"
    if manifest is None:
        with open(MANIFEST) as f:
            manifest = {k: tuple(v) for k, v in json.load(f).items()}
    config = os.path.join(PORT_CONFIGS, "config_stage_2.yaml")
    body_path = os.path.join(IMPORT_DIR, "SMPLX_NEUTRAL.npz")
    ckpt = os.path.join(IMPORT_DIR, "reference.ckpt")
    w2v = os.path.join(DEMO_DIR, "wav2vec2_base")
    if not os.path.exists(os.path.join(w2v, "pytorch_model.bin")):
        wav2vec2_checkout(w2v)
    tone = os.path.join(DEMO_DIR, "tone.wav")
    if not os.path.exists(tone):
        from audio_motion_avatar_tpu_torch.data.speech import write_wav
        t = np.arange(16000) / 16000.0
        write_wav(tone, 0.3 * np.sin(2 * np.pi * 220.0 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)))
    # the manifest's SMPL-X encoder takes sampled image features (vertex_emb
    # 128 wide, fc_pos 259 inputs), which config_stage_2.yaml turns off
    over = ["dataset.type=SyntheticDataset", "dataset.image_size=[512,512]",
            "dataset.length=2", f"dataset.wav2vec2_model_path={w2v}",
            "model.compute_dtype=bfloat16", f"model.triplane_net.smplx_model_path={body_path}",
            "model.triplane_net.sample_feature=true", f"training.output_dir={IMPORT_DIR}",
            CLI_VIT, *extra]
    t0 = time.perf_counter()
    body = release_body(body_path)
    sd, write_s = reference_checkpoint(ckpt, manifest)
    cfg = default_affine_norm_for_import(ConfigLoader.load_config(config, over), ckpt)
    ac = apply_serving_profile(build_avatar_config(cfg), cfg)
    _, dry = torch_import.map_reference_state_dict(sd, ac, stage=2)
    print(f"[{tag}] body ({body.v_template.shape[0]} vertices, {body.faces.shape[0]} faces) and "
          f"checkpoint ({len(sd)} tensors, {sum(v.size for v in sd.values())} values; written in "
          f"{write_s:.1f} s) in {time.perf_counter() - t0:.1f} s; the CPU dry run: "
          f"{dry['loaded']} loaded of {dry['total_torch_modules']} modules, "
          f"{len(dry['skipped_modules'])} skipped", flush=True)

    got = {}
    read, merge = torch_import.import_reference_checkpoint, torch_import.merge_into

    def read_spy(path, ac_, stage=1):
        got.update(t0=time.perf_counter(), norm=ac_.upsampler_norm, stage=stage)
        got["partial"], got["report"] = read(path, ac_, stage)
        return got["partial"], got["report"]

    def merge_spy(model, partial, **kw):
        got["mismatches"] = merge(model, partial, **kw)
        got["seconds"] = time.perf_counter() - got["t0"]
        return got["mismatches"]

    torch_import.import_reference_checkpoint, torch_import.merge_into = read_spy, merge_spy
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        summary, launches, wall = run_main2(["--device", str(dev), "--config", config, "--mode",
                                             "demo", "--checkpoint", ckpt, "--audio", tone, *over])
    finally:
        torch_import.import_reference_checkpoint, torch_import.merge_into = read, merge
    peak = torch.cuda.max_memory_allocated(dev)
    report, mismatches = got["report"], got["mismatches"]
    n = summary["n_chunks"]
    expected = demo_launches(ac, n)
    expected["composite_tiles"] = 0
    frames = demo_frames(IMPORT_DIR)
    losses = [v for _, _, l1, sl in summary["losses"] for v in (l1, sl)]
    sec, chunks = summary["seconds"], summary["chunk_seconds"]
    print(f"[{tag}] import {got['seconds']:.2f} s: {report['loaded']} loaded of "
          f"{report['total_torch_modules']} modules, skipped {len(report['skipped_modules'])}, "
          f"mismatches {mismatches[:4]}; upsampler_norm {got['norm']!r}; {summary['frames']} "
          f"frames, {n} chunks; launches {launches} expected {expected}", flush=True)
    print(f"[{tag}] seconds: build {sec['build']:.2f} (the import in it), overlays "
          f"{sec['overlays']:.2f} ({sec['overlays'] / summary['overlays']:.3f} a frame), "
          f"main2.main wall {wall:.2f}; fps: rollouts {summary['frames'] / sum(chunks):.2f} "
          f"(without the first {2 * ac.triplane_output_frames * (len(chunks) - 1) / max(sum(chunks[1:]), 1e-9):.2f}), "
          f"whole demo {summary['frames'] / wall:.3f}; peak memory {peak / 2**30:.2f} GiB",
          flush=True)
    if mismatches or got["stage"] != 2 or report["loaded"] != dry["loaded"] or \
            report["skipped_modules"] != dry["skipped_modules"]:
        raise AssertionError(f"{tag}: the import differs from the dry run: {report}, {mismatches}")
    if got["norm"] != "affine":
        raise AssertionError(f"{tag}: upsampler_norm {got['norm']!r}, not 'affine'")
    if summary["frames"] != 2 * n * ac.triplane_output_frames or frames.shape[0] != summary["frames"]:
        raise AssertionError(f"{tag}: the demo wrote the wrong number of frames")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{tag}: non-finite demo losses {summary['losses']}")
    if launches != expected:
        raise AssertionError(f"{tag}: launches {launches} != {expected}")
    frames_ok(frames[None], tag)
    return launches


IDOL_SIZE = (896, 640)


def idol_fixture(root, body, dev, scenes, views, size=IDOL_SIZE, seed=0):
    """IDOL caches in the reference layout, written by the port: `scenes`
    (n_train, n_val) scenes, each a seeded pose of the synthetic body
    (global_orient 0, transl (0, 0.35, 0) in its 189-d vector) rendered by
    render_gt_video from `views` cameras orbiting it, looking at its transl
    (the renders place the body there: the trap of ROADMAP section 3), with
    the reader's default intrinsics (focal 1120, the centre) at size (H, W);
    each scene a {'param_path'} entry whose .npy holds poses (w2c, centre),
    smpl_params and image_paths. Returns (train cache, val cache, seconds)."""
    import shutil

    import numpy as np
    from audio_motion_avatar_tpu_torch.data import idol
    from audio_motion_avatar_tpu_torch.data.containers import VideoBatch
    from audio_motion_avatar_tpu_torch.data.synthetic import random_smpl_params, render_gt_video
    from audio_motion_avatar_tpu_torch.ops.cameras import orbit_camera
    from audio_motion_avatar_tpu_torch.utils.video import to_uint8

    t0 = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    H, W = size
    K = np.array([[idol.DEFAULT_FOCAL, 0, W // 2], [0, idol.DEFAULT_FOCAL, H // 2], [0, 0, 1]],
                 np.float32)
    entries = []
    for s in range(sum(scenes)):
        one = random_smpl_params(np.random.RandomState(seed + s), (1, 1))
        one["global_orient"][:] = 0.0
        one["transl"][:] = (0.0, 0.35, 0.0)
        vec = np.concatenate([np.ones(1, np.float32)] + [one[k][0, 0] for k in idol.SMPL_KEYS[1:]])
        smpl = {k: np.repeat(v, views, axis=1) for k, v in one.items()}
        Es = np.stack([orbit_camera(angle=2 * np.pi * v / views + 0.2 * s, height=0.35,
                                    image_size=size)[1] for v in range(views)])
        cams = {"intrinsic": np.tile(K, (1, views, 1, 1)),
                "extrinsic": (Es @ translation(one["transl"][0, 0]))[None]}
        video = render_gt_video(body, VideoBatch(None, smpl, cams), size, dev)[0]
        paths = []
        for v in range(views):
            paths.append(os.path.join(root, f"scene{s}", f"{v:03d}.png"))
            png_write(paths[-1], to_uint8(video[v].transpose(1, 2, 0)))
        param = {"poses": [[E, -E[:3, :3].T @ E[:3, 3]] for E in Es], "smpl_params": vec,
                 "image_paths": paths, "video_path": None}
        path = os.path.join(root, f"scene{s}", "param.npy")
        np.save(path, np.asarray(param, dtype=object), allow_pickle=True)
        entries.append({"param_path": path})
    caches = []
    for name, part in (("train", entries[:scenes[0]]), ("val", entries[scenes[0]:] or entries)):
        caches.append(os.path.join(root, f"cache_{name}.npy"))
        np.save(caches[-1], np.asarray(part, dtype=object), allow_pickle=True)
    return caches[0], caches[1], time.perf_counter() - t0


def cli_train_idol(dev, phase10_ms, size=IDOL_SIZE, extra=()):
    """16: `main.main --mode train` on config_stage_1_idol.yaml (bf16): the
    IDOL reader on caches in the reference layout under build/cli/idol (4
    train and 1 val scene of 12 views at the shipped 896 x 640, H != W),
    specific_observation_num 8 (a reference view and 7 targets), from a
    checkpoint of seeded weights made as phase 13's: one epoch of 4
    micro-steps at accumulate 4, the validation and the monitored
    checkpoint; then `main.main --mode test` from it, whose metrics must
    equal the fit's validation as in phase 13. Checks finite losses, moved
    parameters, a bit-identical ViT and the K1 / K2 / A / A-bwd launches as
    the config implies; prints the ms of a micro-step beside phase 10's (1024^2,
    8 views), the reader's host seconds an item and the peak memory. size
    and extra rehearse it small."""
    import shutil

    import torch
    from audio_motion_avatar_tpu_torch import main as cli1
    from audio_motion_avatar_tpu_torch.configs import ConfigLoader
    from audio_motion_avatar_tpu_torch.configs.build import build_avatar_config
    from audio_motion_avatar_tpu_torch.data import idol
    from audio_motion_avatar_tpu_torch.ops import smplx as smplx_ops

    tag = "train CLI, IDOL"
    config = os.path.join(PORT_CONFIGS, "config_stage_1_idol.yaml")
    root, out = os.path.join(CLI_DIR, "idol"), os.path.join(CLI_DIR, "idol_run")
    train, val, fixture_s = idol_fixture(root, smplx_ops.synthetic_model(seed=0), dev, (4, 1), 12,
                                         size)
    over = ["model.compute_dtype=bfloat16", f"dataset.cache_path_train=[{train}]",
            f"dataset.cache_path_val=[{val}]", "training.max_epochs=1",
            f"dataset.image_size=[{size[0]},{size[1]}]",
            "training.logging.log_every_n_steps=1", f"training.output_dir={out}", CLI_VIT,
            *extra]
    t0 = time.perf_counter()
    ckpt = os.path.join(CLI_DIR, "idol_ckpt")
    start = cli_checkpoint(1, config, over, ckpt)
    print(f"[{tag}] fixture (5 scenes x 12 views at {size[0]} x {size[1]}) {fixture_s:.1f} s, "
          f"seeded checkpoint {time.perf_counter() - t0:.1f} s", flush=True)
    shutil.rmtree(out, ignore_errors=True)
    host, models = {}, []
    peak_memory(dev, reset=True)
    t0 = time.perf_counter()
    with counted() as fit_launches, \
            built_models(cli1, "build_everything", lambda out: out[0], models), \
            host_seconds(idol.AvatarDataset, "__getitem__", host, "items"):
        cli1.main(["--device", str(dev), "--config", config, "--mode", "train",
                   "--checkpoint", ckpt, *over])
    fit_s = time.perf_counter() - t0
    peak = peak_memory(dev)
    model, vit_before = models[0]
    scalars = logged_scalars(out)
    losses = [v for _, t, v in scalars if t == "train/loss"]
    step_ms = [1e3 * v for _, t, v in scalars if t == "train/step_time_s"]
    val_metrics = {t[4:]: v for _, t, v in scalars if t.startswith("val/")}
    trained_checks(tag, model, start, vit_before, losses)
    del models[:], model, vit_before
    torch.cuda.empty_cache()
    with counted() as test_launches:
        metrics = cli1.main(["--device", str(dev), "--config", config, "--mode", "test",
                             "--checkpoint", os.path.join(out, "checkpoints"), *over])
    ac = build_avatar_config(ConfigLoader.load_config(config, over))
    views = int(ConfigLoader.load_config(config, over).dataset.specific_observation_num) - 1
    want_fit = add_launches((train_launches(ac, 1, 1, 1, views), len(losses)),
                            (forward_launches(ac, 1, 1, 1), 1),
                            (forward_launches(ac, 1, 1, 1, novel=True), 1))
    want_test = add_launches((forward_launches(ac, 1, 1, 1, novel=True), 1),
                             (forward_launches(ac, 1, 1, 1), 1))
    ratio = {k: abs(metrics[k] - v) / (1e-5 * max(abs(v), 1e-3)) for k, v in val_metrics.items()}
    items = host["items calls"]
    print(f"[{tag}] main.main train {fit_s:.1f} s ({len(losses)} micro-steps of a reference view "
          f"and {views} targets at {size[0]} x {size[1]}); losses {[round(v, 5) for v in losses]}; "
          f"ms a micro-step through the CLI {[round(v, 1) for v in step_ms]} (mean "
          f"{sum(step_ms) / len(step_ms):.1f}, without the first "
          f"{sum(step_ms[1:]) / max(len(step_ms) - 1, 1):.1f}; phase 10 at 1024^2 with 8 views "
          f"{phase10_ms:.1f}); the reader {host['items'] / items:.3f} s an item ({items} items); "
          f"test against the fit's validation: worst |diff| / bound {max(ratio.values()):.3f}; peak "
          f"memory {peak / 2**30:.2f} GiB", flush=True)
    print(f"[{tag}] launches: fit {fit_launches} expected {want_fit}; test {test_launches} "
          f"expected {want_test}", flush=True)
    if len(losses) != 4 or sorted(metrics) != sorted(val_metrics) or max(ratio.values()) > 1.0:
        raise AssertionError(f"{tag}: {len(losses)} micro-steps, or the test metrics differ "
                             f"from the fit's validation")
    if os.listdir(os.path.join(out, "checkpoints")) != ["4"]:
        raise AssertionError(f"{tag}: the checkpoint is missing")
    if fit_launches != want_fit or test_launches != want_test:
        raise AssertionError(f"{tag}: launches differ from what the config implies")
    return fit_launches


def grey_sh(model, bias=-2.0, weight_scale=1.0):
    """Seeded SH heads give every coefficient about sigmoid(0) = 0.5, so the
    colours sit near 0.64 plus view terms that reach past white (the SH
    colour has no upper clamp); a lower bias keeps them grey against the
    white background, the view terms still visible. weight_scale quiets the
    head's noise where its features are large (the planes without the
    upsampler feed it the fusion's raw tokens)."""
    import torch
    with torch.no_grad():
        model.renderer.shs_layer.bias.fill_(bias)
        model.renderer.shs_layer.weight.mul_(weight_scale)


def render_form_configs(base):
    """The sparse serving forms of phases 17a and 17 on `base` (which
    samples by quad rows): name -> configuration."""
    import dataclasses
    return {"quad": base,
            "4-tap": dataclasses.replace(base, sample_quad=False),
            "slab": dataclasses.replace(base, sample_quad=False, sample_slab=True),
            "4-tap, sparse penultimate": dataclasses.replace(
                base, sample_quad=False, upsampler_sparse_penultimate=True)}


def check_small_forms(dev):
    """17a: the render forms at the tiny profile on the card against the CPU
    (plain versions), the same seeded weights on both: fp32 rollouts with
    SH colours (rgb False) at degrees 1 and 3 in the quad, 4-tap, slab and
    sparse-penultimate forms (tiles of 8 px, 6 of 16 kept; 3 of 4 at the
    penultimate level), and without the upsampler, frames mean|diff| <= 1e-3
    (phase 3's bound); a stage-1 forward with the encoder's upsample path
    and SH colours, frames mean|diff| <= 1e-3 (phase 6's); one stage-1 train
    step with rgb False and one with the sparse upsampler sampled by four
    taps, each held as phase 9 holds its steps (hold_train_step). Returns
    the launches of S, Q, A, K1, K2 and A-bwd on the card (the bf16 train
    steps' as hold_train_step counts them)."""
    import dataclasses

    import torch
    from audio_motion_avatar_tpu_torch.data.synthetic import make_batch, to_device
    from audio_motion_avatar_tpu_torch.models.config import AvatarConfig, serving_config
    from audio_motion_avatar_tpu_torch.ops import attention as at
    from audio_motion_avatar_tpu_torch.ops import smplx as smplx_ops
    from audio_motion_avatar_tpu_torch.ops import splat_segmented as ss
    from audio_motion_avatar_tpu_torch.ops import splat_tiles as st
    from audio_motion_avatar_tpu_torch.ops import triplane as tp
    from audio_motion_avatar_tpu_torch.reconstruct import build_reconstructor
    from audio_motion_avatar_tpu_torch.serve import build_rollout, synthetic_inputs
    from audio_motion_avatar_tpu_torch.weights import perturb_heads

    tag = "small forms"
    body = smplx_ops.synthetic_model(seed=0, num_verts=300)
    counters = (at.attention, at.attention_bwd, tp.quad_rows, ss.composite_segments,
                st.composite_tiles, st.composite_tiles_bwd)
    for fn in counters:
        fn.launches = 0

    def rollout(cfg, d):
        r = build_rollout(cfg, device=d, smplx_model=body, seed=0)
        perturb_heads(r.model, seed=1, std=0.05)
        tame_seeded_weights(r.model)
        visible_heads(r.model)
        if not cfg.rgb:
            grey_sh(r.model)
        tri, smpl, audio, cams = synthetic_inputs(cfg, 2, d, seed=0)
        return r(tri, smpl, audio, cams)[0].float().cpu()

    tiny = serving_config(AvatarConfig.tiny(image_size=(32, 32)), num_upsample_blocks=2,
                          max_per_tile=512, upsampler_norm="affine",
                          upsampler_sparse_tile_px=8, upsampler_sparse_max_tiles=6,
                          upsampler_sparse_pen_max_tiles=3)
    cases = {f"SH degree {deg}, {form}": cfg for deg in (1, 3)
             for form, cfg in render_form_configs(
                 dataclasses.replace(tiny, rgb=False, sh_degree=deg)).items()}
    cases["no upsampler"] = dataclasses.replace(tiny, upsample_triplane=False)
    for name, cfg in cases.items():
        card, cpu = rollout(cfg, dev), rollout(cfg, "cpu")
        diff = float((card - cpu).abs().mean())
        print(f"[{tag}] tiny fp32 rollout, {name}: card vs CPU frames mean|diff|={diff:.3e} "
              f"(tol 1e-3), per-frame std min {float(card.reshape(12, -1).std(1).min()):.4f}",
              flush=True)
        if not (diff <= 1e-3 and torch.isfinite(card).all()):
            raise AssertionError(f"{tag}: tiny rollout ({name}) on the card disagrees with the CPU")

    ref_np, test_np = make_batch(1, 1, (64, 64), seed=0), make_batch(1, 3, (64, 64), seed=1)

    def reconstruct(cfg, d, image_tokens=None):
        rec = build_reconstructor(cfg, device=d, smplx_model=body, seed=0)
        perturb_heads(rec.model, seed=1, std=0.05)
        visible_heads(rec.model)
        grey_sh(rec.model)
        if image_tokens is not None:
            flat = image_tokens.to(d).reshape((-1,) + image_tokens.shape[2:])
            rec.model.sapiens_encoder.forward = lambda images: flat
        out = rec(to_device(ref_np, d), to_device(test_np, d))
        return [x.float().cpu() for x in (out.reference, out.novel, out.output.image_tokens)]

    cfg = dataclasses.replace(AvatarConfig.tiny(image_size=(64, 64)),
                              upsample_triplane_encoder=True, rgb=False, sh_degree=1)
    cpu = reconstruct(cfg, "cpu")
    card = reconstruct(cfg, dev, cpu[2])
    diff = float(torch.cat([(card[i] - cpu[i]).abs().flatten() for i in (0, 1)]).mean())
    print(f"[{tag}] tiny fp32 reconstruction, encoder upsample path (scatter at "
          f"{3 * cfg.triplane_resolution}^2, downsampled to {cfg.triplane_resolution}^2), SH "
          f"degree 1: card vs CPU frames mean|diff|={diff:.3e} (tol 1e-3)", flush=True)
    if not (diff <= 1e-3 and torch.isfinite(card[0]).all()):
        raise AssertionError(f"{tag}: tiny reconstruction on the card disagrees with the CPU")

    total = {fn.__name__: fn.launches for fn in counters}
    tiny_train = AvatarConfig.tiny(image_size=(32, 32))
    for name, knobs in (("stage 1, rgb=False (SH degree 1)", dict(rgb=False, sh_degree=1)),
                        ("stage 1, sparse upsampler, 4-tap",
                         dict(upsampler_sparse=True, upsampler_sparse_tile_px=4,
                              upsampler_sparse_max_tiles=6))):
        step = hold_train_step(dev, 1, dataclasses.replace(tiny_train, **knobs), name, tag=tag)
        for k, v in step.items():
            total[k] = total.get(k, 0) + v
    print(f"[{tag}] launches on the card {total}", flush=True)
    return total


def check_launches(name, launches, want):
    """Fail unless a path's kernel launches are what its configuration
    implies (kernels that launched nothing left out of both)."""
    launches, want = ({k: v for k, v in d.items() if v} for d in (launches, want))
    if launches != want:
        raise AssertionError(f"{name}: launches {launches} != {want}")


def run_render_forms(dev, phase4_fps, phase7_ms, phase10_ms):
    """17: the render forms at full width, bf16, the synthetic body, seeded
    weights. Serving: one model with SH colours of degree 3 (a 48-wide shs
    head) at the serving shape (B = 2, T_in = 2, T_out = 6, 512^2), 1
    warm-up and 2 requests in each form of render_form_configs on the same
    tokens and audio: launches, frames_ok, fps beside phase 4's; slab,
    quad and the sparse penultimate form against 4-tap under frames_close.
    Stage-1 training: AvatarConfig() with SH colours of degree 3 and the
    encoder's upsample path (scatter at 96^2, downsampled to 32^2), 1024^2,
    one reference view and 8 test views, train_stage1.yaml's optimizer
    (accumulate 4): on the seeded weights, the novel views not blank and a
    reconstruction with them without the upsampler (upsample_triplane
    False), 1 warm-up and 1 request beside phase 7's; then 1 warm-up and 4
    micro-steps, so that the window holds one update in four micro-steps as
    phase 10's holds two in eight: launches, finite losses, the
    downsampler, the shs head and the loss moved by the update; ms a
    micro-step beside phase 10's, peak memory. Returns the launches of the
    three parts, summed."""
    import dataclasses

    import numpy as np
    import torch
    from audio_motion_avatar_tpu_torch.data.synthetic import make_batch, to_device
    from audio_motion_avatar_tpu_torch.models.config import AvatarConfig, serving_config
    from audio_motion_avatar_tpu_torch.ops import attention as at
    from audio_motion_avatar_tpu_torch.ops import splat_segmented as ss
    from audio_motion_avatar_tpu_torch.ops import splat_tiles as st
    from audio_motion_avatar_tpu_torch.ops import triplane as tp
    from audio_motion_avatar_tpu_torch.reconstruct import build_reconstructor
    from audio_motion_avatar_tpu_torch.serve import build_rollout, serve, synthetic_inputs
    from audio_motion_avatar_tpu_torch.train import STAGE1_OPTIM
    from audio_motion_avatar_tpu_torch.training import stage1
    from audio_motion_avatar_tpu_torch.weights import perturb_heads

    tag = "render forms"
    dev = torch.device(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    counters = (at.attention, at.attention_bwd, tp.quad_rows, ss.composite_segments,
                st.composite_tiles, st.composite_tiles_bwd)
    total = {fn.__name__: 0 for fn in counters}

    def reset():
        for fn in counters:
            fn.launches = 0

    def read():     # the launches since the last reset or read, added to total
        got = {fn.__name__: fn.launches for fn in counters}
        reset()
        for k, v in got.items():
            total[k] += v
        return {k: v for k, v in got.items() if v}

    base = serving_config(AvatarConfig(), image_size=(512, 512),
                          upsampler_norm="affine", rgb=False, sh_degree=3)
    # phase 4's seeded RGB model, its 3-wide colour head widened to 48
    # coefficients (seeded noise, grey_sh's bias): the same bodies as phase 4
    t0 = time.perf_counter()
    rgb = build_rollout(dataclasses.replace(base, rgb=True, sh_degree=0), device=dev,
                        dtype=torch.bfloat16, seed=0)
    perturb_heads(rgb.model, seed=1, std=1e-2)
    tame_seeded_weights(rgb.model)
    weights = rgb.model.state_dict()
    del rgb
    head = next(k[:-len(".weight")] for k in weights if k.endswith("renderer.shs_layer.weight"))
    width = 3 * (base.sh_degree + 1) ** 2
    g = torch.Generator().manual_seed(2)
    weights[head + ".weight"] = (1e-2 * torch.randn(
        width, weights[head + ".weight"].shape[1], generator=g)).to(dev)
    weights[head + ".bias"] = torch.full((width,), -2.0, device=dev)
    first = build_rollout(base, device=dev, dtype=torch.bfloat16, state_dict=weights)
    print(f"[{tag}] serving models built in {time.perf_counter() - t0:.1f} s (shs head "
          f"{first.model.renderer.shs_layer.out_features} wide)", flush=True)
    tri, smpl, audio, cams = synthetic_inputs(base, 2, dev, seed=0)
    rng = np.random.RandomState(1)
    reqs = [(torch.as_tensor(rng.randn(*audio.shape).astype(np.float32) * 0.1, device=dev), cams)
            for _ in range(2)]
    mcfg = first.model.cfg
    B, T_out = 2, mcfg.triplane_output_frames
    n_chunks = B * T_out // mcfg.frames_per_chunk
    dec0 = mcfg.ptv3_dec_depths[0] if mcfg.ptv3_dec_channels[0] // mcfg.ptv3_dec_heads[0] == 64 else 0
    frames = {}
    for name, cfg in render_form_configs(base).items():
        roll = first if name == "quad" else build_rollout(cfg, device=dev, dtype=torch.bfloat16,
                                                          state_dict=weights)
        list(serve(roll, tri, smpl, [(audio, cams)]))
        sync()
        reset()
        times, out = [], []
        it = serve(roll, tri, smpl, reqs)
        for _ in reqs:
            t0 = time.perf_counter()
            rendered, _ = next(it)
            sync()
            times.append(time.perf_counter() - t0)
            out.append(rendered.float())
        launches = read()
        want = {"attention": (mcfg.audio_transformer_layers * T_out + dec0 * n_chunks) * len(reqs),
                "quad_rows": n_chunks * len(reqs) if cfg.sample_quad else 0,
                "composite_segments": n_chunks * len(reqs)}
        fps = B * T_out * len(times) / sum(times)
        print(f"[{tag}] serving, SH degree 3, {name}: requests "
              f"{', '.join(f'{1e3 * s:.1f}' for s in times)} ms, fps {fps:.2f} (phase 4, "
              f"RGB quad: {phase4_fps:.2f}); launches {launches} "
              f"expected {want}", flush=True)
        check_launches(f"{tag}: {name}", launches, want)
        for i, fr in enumerate(out):
            frames_ok(fr, f"{tag} {name} request {i}")
        frames[name] = out
        if roll is not first:
            del roll
    for i in range(len(reqs)):
        for name in ("slab", "quad", "4-tap, sparse penultimate"):
            frames_close(frames[name][i], frames["4-tap"][i], f"{tag} {name} request {i}",
                         against="the 4-tap form's")
    del first, weights, frames
    torch.cuda.empty_cache()

    cfg = AvatarConfig(rgb=False, sh_degree=3, upsample_triplane_encoder=True)
    H, W = cfg.image_size
    t0 = time.perf_counter()
    tr = seeded_trainer(1, cfg, dev, torch.bfloat16, optim=STAGE1_OPTIM)
    grey_sh(tr.model)
    print(f"[{tag}] stage-1 trainer built in {time.perf_counter() - t0:.1f} s", flush=True)
    ref = to_device(make_batch(1, 1, (H, W), seed=0), dev)
    test = to_device(make_batch(1, 8, (H, W), seed=1), dev)
    # the seeded weights before any update (one Adam step on seeded weights
    # can move every body out of the views): the novel views, and a
    # reconstruction with them but without the upsampler
    with torch.no_grad():
        novel = stage1.stage1_loss(tr.model, tr.statics, ref, test, cfg)[3]
    frames_ok(novel, f"{tag} stage-1 novel views")
    del novel
    read()      # that forward's launches are in no expectation below
    rcfg = dataclasses.replace(cfg, upsample_triplane=False)
    rec = build_reconstructor(rcfg, device=dev, dtype=torch.bfloat16, state_dict={
        k: v for k, v in tr.model.state_dict().items() if not k.startswith("renderer.upsampler.")})
    grey_sh(rec.model, weight_scale=0.01)
    rec(ref, test)
    sync()
    reset()
    t0 = time.perf_counter()
    out = rec(ref, test)
    sync()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = read()
    want = reconstruction_launches(rcfg)
    print(f"[{tag}] reconstruction without the upsampler ({rcfg.triplane_resolution}^2 "
          f"planes), SH degree 3: request {ms:.1f} ms (phase 7: "
          f"{phase7_ms:.1f}); launches {launches} expected "
          f"{want}", flush=True)
    check_launches(f"{tag}: reconstruction", launches, want)
    frames_ok(out.reference, f"{tag} reconstruction reference")
    frames_ok(out.novel, f"{tag} reconstruction novel")
    del rec, out
    torch.cuda.empty_cache()

    new = {k: p.detach().clone() for k, p in tr.state.trainable.items()
           if "triplane_downsampler." in k or "renderer.shs_layer." in k}
    m = tr.step(ref, test)
    sync()
    reset()
    peak_memory(dev, reset=True)
    times, metrics = [], []
    for _ in range(STAGE1_OPTIM.accumulate_steps):
        t0 = time.perf_counter()
        metrics.append(tr.step(ref, test))
        sync()
        times.append(time.perf_counter() - t0)
    peak = peak_memory(dev)
    launches = read()
    want = {k: len(times) * v for k, v in train_launches(cfg, 1, 1, 1, 8).items()}
    ms = 1e3 * sum(times) / len(times)
    print(f"[{tag}] stage-1 train, SH degree 3, encoder upsample path: warm-up loss "
          f"{m['loss']:.5f}; micro-steps {', '.join(f'{1e3 * s:.1f}' for s in times)} ms, "
          f"{ms:.1f} ms a micro-step (phase 10: {phase10_ms:.1f}), losses "
          f"{[round(mt['loss'], 5) for mt in metrics]}, peak memory {peak / 2**30:.2f} GiB; "
          f"launches {launches} expected {want}", flush=True)
    check_launches(f"{tag}: stage-1 train", launches, want)
    if not all(np.isfinite([mt["loss"], mt["grad_norm"]]).all() for mt in metrics):
        raise AssertionError(f"{tag}: non-finite loss or gradient norm")
    # the window holds one update (the warm-up and three micro-steps
    # accumulate, the fourth applies): the new parameters moved, and the
    # last micro-step's loss, taken after it, moved with them
    moved = sorted(k.split("triplane_downsampler.")[-1].split("renderer.")[-1]
                   for k, p in tr.state.trainable.items()
                   if k in new and not torch.equal(p.detach(), new[k]))
    print(f"[{tag}] stage-1 train: the update moved {len(moved)} of the {len(new)} tensors of "
          f"the downsampler and the shs head: {moved}", flush=True)
    if not (any(k.startswith("shs_layer.") for k in moved)
            and any(k.startswith(("block_", "down.")) for k in moved)
            and metrics[-1]["loss"] != metrics[0]["loss"]):
        raise AssertionError(f"{tag}: the stage-1 update did not move the downsampler, the "
                             f"shs head and the loss ({moved})")
    del tr
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# 18a / 18: parallelism (parallel/): ranks as processes of this script
# ---------------------------------------------------------------------------

PAR_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "parallel")
PAR_COUNTERS = ("attention", "attention_bwd", "composite_tiles", "composite_tiles_bwd")


def free_port():
    """A free TCP port on localhost (the rendezvous of a launched group)."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_procs(name, argvs, envs):
    """One process of `python3 -m ...` / this script a rank: argvs[r] its
    arguments, envs[r] its extra environment; output into build/parallel/
    <name>.<rank>.log. -> [(Popen, log path)]."""
    os.makedirs(PAR_DIR, exist_ok=True)
    procs = []
    for r, (argv, env) in enumerate(zip(argvs, envs)):
        log = os.path.join(PAR_DIR, f"{name}.{r}.log")
        with open(log, "w") as f:
            procs.append((subprocess.Popen([sys.executable, *argv], stdout=f,
                                           stderr=subprocess.STDOUT,
                                           env=dict(os.environ, **env),
                                           cwd=os.path.dirname(os.path.abspath(__file__))),
                          log))
    return procs


def wait_procs(procs, timeout, name):
    """Wait for every rank (killing what outlives `timeout` seconds from
    now); -> [(return code, the log's text)]."""
    deadline, out = time.perf_counter() + timeout, []
    try:
        for p, log in procs:
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                p.kill()
                rc = p.wait()
                print(f"[{name}] {log}: killed after its time limit", flush=True)
            with open(log) as f:
                out.append((rc, f.read()))
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def ranks_ok(results, name):
    """Fail (with each rank's last lines) unless every rank exited 0."""
    if any(rc != 0 for rc, _ in results):
        raise AssertionError(f"{name}: " + " | ".join(
            f"rank {r} rc {rc}: {text[-3000:]}" for r, (rc, text) in enumerate(results)))


@contextlib.contextmanager
def head_shapes(into):
    """The (B, H, S, D) of every query handed to kernel A's entry
    (transformer.attention_autograd: the audio, predictor and fusion
    transformers and the 64-wide PTv3 patches) while the block runs."""
    import audio_motion_avatar_tpu_torch.models.transformer as tf
    orig = tf.attention_autograd

    def spy(q, *args, **kw):
        into.append(tuple(q.shape))
        return orig(q, *args, **kw)

    tf.attention_autograd = spy
    try:
        yield into
    finally:
        tf.attention_autograd = orig


def load_rank(d, r):
    import torch
    return torch.load(os.path.join(d, f"out.{r}.pt"), weights_only=False)


def small_parallel_cfg(stage):
    """18a's tiny configuration (32x32), phase 9's bf16 one: 64-wide heads
    so that A and A-bwd run on the local heads (2 heads, 1 a model rank)."""
    import dataclasses

    from audio_motion_avatar_tpu_torch.models.config import AvatarConfig
    return dataclasses.replace(AvatarConfig.tiny(image_size=(32, 32)),
                               smplx_transformer_head_dim=64, cross_transformer_head_dim=64,
                               audio_transformer_head_dim=64)


def small_parallel_batches(stage, cfg, d):
    """Phase 9's first global batch of 2: stage 1 one reference view and 3
    test views a row, stage 2 its reference and target frames with audio."""
    from audio_motion_avatar_tpu_torch.data.synthetic import make_batch, to_device
    ref, tgt = 0, 1
    size = tuple(cfg.image_size)
    if stage == 1:
        return (to_device(make_batch(2, 1, size, seed=ref), d),
                to_device(make_batch(2, 3, size, seed=tgt), d))
    return (to_device(make_batch(2, cfg.triplane_input_frames, size, seed=ref), d),
            to_device(make_batch(2, cfg.triplane_output_frames, size, seed=tgt,
                                 with_audio=True, audio_dim=cfg.audio_feature_dim), d))


def small_parallel_step(stage, dev, dtype, mesh=None):
    """One tiny train step of small_parallel_cfg(stage) on this rank's rows
    (mesh), seeded weights: (metrics, the averaged gradients gathered whole,
    fp32 on the CPU, the launches, kernel A's (B, H, S, D) shapes)."""
    from audio_motion_avatar_tpu_torch.ops import attention as at
    from audio_motion_avatar_tpu_torch.ops import smplx as smplx_ops
    from audio_motion_avatar_tpu_torch.ops import splat_tiles as st
    from audio_motion_avatar_tpu_torch.parallel import mesh as pmesh
    from audio_motion_avatar_tpu_torch.train import build_trainer
    from audio_motion_avatar_tpu_torch.training.train_state import OptimConfig
    from audio_motion_avatar_tpu_torch.weights import perturb_heads

    cfg = small_parallel_cfg(stage)
    body = smplx_ops.synthetic_model(seed=0, num_verts=300)
    # seeded_trainer's visible weights, made on the whole model (the CPU),
    # then loaded into the trainer, which cuts them over the mesh
    whole = build_trainer(stage, cfg, device="cpu", dtype=dtype, smplx_model=body).model
    perturb_heads(whole, seed=1, std=0.05)
    if stage == 2:
        tame_seeded_weights(whole)
    visible_heads(whole)
    tr = build_trainer(stage, cfg, device=dev, dtype=dtype, smplx_model=body,
                       optim=OptimConfig(learning_rate=1e-3, accumulate_steps=1),
                       state_dict=whole.state_dict(), mesh=mesh)
    del whole
    ref, tgt = small_parallel_batches(stage, cfg, dev)
    if mesh is not None:
        ref, tgt = pmesh.batch_rows(ref, mesh), pmesh.batch_rows(tgt, mesh)
    shapes = []
    fns = (at.attention, at.attention_bwd, st.composite_tiles, st.composite_tiles_bwd)
    for fn in fns:
        fn.launches = 0
    with head_shapes(shapes):
        m = tr.step(ref, tgt, 0)
    launches = {fn.__name__: fn.launches for fn in fns}
    grads = tr.state.gather(tr.state.grads())
    return (m, {k: v.float().cpu() for k, v in grads.items()}, launches, shapes)


def rank_main(argv):
    """A rank of 18a's group: python3 chip_smoke.py --rank DIR RANK WORLD
    BACKEND DEVICE: joins through DIR/rendezvous on DEVICE (the card's
    cuda:0), runs the tiny DP (2, 1) and TP (1, 2) steps of both stages
    (gloo) or the NCCL probe (nccl: two ranks of one communicator on one
    card), saves DIR/out.RANK.pt."""
    import torch
    import torch.distributed as dist
    d, rank, world, backend = argv[0], int(argv[1]), int(argv[2]), argv[3]
    dev = torch.device(argv[4])
    torch.set_num_threads(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from audio_motion_avatar_tpu_torch.parallel import mesh as pmesh
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{os.path.join(d, 'rendezvous')}",
                            rank=rank, world_size=world)
    out = {}
    if backend == "nccl":
        t = torch.ones(4, device=dev)
        try:
            dist.all_reduce(t)
            torch.cuda.synchronize()
            out["nccl"] = f"no error: the all-reduce gave {t.tolist()}"
        except Exception as e:            # the probe's finding, reported
            out["nccl"] = f"{type(e).__name__}: {str(e).strip().splitlines()[0][:400]}"
        torch.save(out, os.path.join(d, f"out.{rank}.pt"))
        os._exit(0)
    for stage in (1, 2):
        for shape in ((2, 1), (1, 2)):
            mesh = pmesh.make_mesh(*shape)
            m, g, launches, shapes = small_parallel_step(stage, dev, torch.bfloat16, mesh)
            out[(stage, shape)] = dict(metrics=m, grads=g, launches=launches, shapes=shapes)
    torch.save(out, os.path.join(d, f"out.{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def check_small_parallel(dev, bounds9):
    """18a: tiny stage-1 and stage-2 train steps over (2, 1) and (1, 2), two
    processes on the one card joined by gloo with CUDA tensors (NCCL refuses
    two ranks of one communicator on one card: a probe pair shows it, the
    error printed once), each held to the one-process step on the card:
    loss |diff| and the gathered gradients' relative distance within 3x the
    largest distance between the CPU's bf16 step (attention rounded as the
    kernels round) and its fp32 step over three draws of the batch, phase
    9's rule, set before the ranks' numbers are read: phase 9's own
    (bounds9: the same configurations, weights and batches of 2); launches
    as the local batch implies, kernel A on the local heads. Then `main2 --mode train`
    on config_tiny.yaml at world size 1 over NCCL (training.multihost with
    torchrun's variables). Returns the launches of the ranks' steps (summed
    over ranks) and the stage-2 gradients' bound (relative), for phase 18."""
    import shutil

    import torch
    if dev.type == "cuda":
        torch.cuda.empty_cache()      # the card's memory for the ranks
    d = os.path.join(PAR_DIR, "small")
    probe_d = os.path.join(PAR_DIR, "nccl_probe")
    for p in (d, probe_d):
        shutil.rmtree(p, ignore_errors=True)
        os.makedirs(p)
    me = os.path.abspath(__file__)
    on = "cuda:0" if dev.type == "cuda" else "cpu"
    probe = start_procs("nccl_probe", [[me, "--rank", probe_d, str(r), "2", "nccl", on]
                                       for r in range(2)], [{}, {}])
    ranks = start_procs("small", [[me, "--rank", d, str(r), "2", "gloo", on]
                                  for r in range(2)], [{}, {}])
    out1 = os.path.join(PAR_DIR, "nccl_world1")
    shutil.rmtree(out1, ignore_errors=True)
    nccl1 = start_procs("nccl_world1", [[
        "-m", "audio_motion_avatar_tpu_torch.main2", "--device", str(dev), "--config",
        os.path.join(PORT_CONFIGS, "config_tiny.yaml"), "--mode", "train",
        f"training.output_dir={out1}", "training.multihost=true"]],
        [{"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
          "MASTER_PORT": str(free_port())}])
    try:
        # the bounds (CPU) and the one-process steps (card) meanwhile
        tol, ref = bounds9, {}
        for stage in (1, 2):
            ref[stage] = small_parallel_step(stage, dev, torch.bfloat16)
            print(f"[small parallel] stage {stage}: bound (phase 9's: 3x the CPU's bf16 vs fp32 "
                  f"over three draws) loss {tol[stage][0]:.3e}, "
                  f"gradients relative {tol[stage][1]:.3e}; "
                  f"one-process card step loss {ref[stage][0]['loss']:.6f} grad_norm "
                  f"{ref[stage][0]['grad_norm']:.6f}, launches {ref[stage][2]}", flush=True)
    finally:
        probe_res = wait_procs(probe, 90, "nccl probe")
        rank_res = wait_procs(ranks, 300, "small parallel")
        nccl1_res = wait_procs(nccl1, 300, "NCCL world 1")
    # the probe is an observation of NCCL's, not a check of the port's
    said = sorted({load_rank(probe_d, r)["nccl"] for r in range(2)
                   if os.path.exists(os.path.join(probe_d, f"out.{r}.pt"))})
    print(f"[small parallel] NCCL, two ranks of one communicator on one card: "
          f"{said[0] if said else 'no answer'} (exit codes "
          f"{[rc for rc, _ in probe_res]})", flush=True)
    ranks_ok(rank_res, "small parallel")
    ranks_ok(nccl1_res, "NCCL world 1")
    log1 = nccl1_res[0][1]
    if f"backend {'nccl' if dev.type == 'cuda' else 'gloo'}" not in log1 or \
            "[main2] training done" not in log1:
        raise AssertionError(f"NCCL world 1: {log1[-2000:]}")
    print("[small parallel] main2 --mode train at world size 1 over NCCL: "
          + next(line for line in log1.splitlines() if "[distributed]" in line), flush=True)
    total = {}
    outs = [load_rank(d, r) for r in range(2)]
    for stage in (1, 2):
        m0, g0, l0, _ = ref[stage]
        cfg = small_parallel_cfg(stage)
        T_in, T_out = (1, 3) if stage == 1 else (cfg.triplane_input_frames,
                                                 cfg.triplane_output_frames)
        for shape in ((2, 1), (1, 2)):
            B = 2 // shape[0]
            want = train_launches(cfg, stage, B, T_in, T_out)
            for r, o in enumerate(outs):
                got = o[(stage, shape)]
                dl = abs(got["metrics"]["loss"] - m0["loss"])
                dg = grads_distance(got["grads"], g0)
                heads = sorted({s[1] for s in got["shapes"]})
                print(f"[small parallel] stage {stage} mesh {shape} rank {r}: loss "
                      f"{got['metrics']['loss']:.6f} (|diff| {dl:.3e}, tol {tol[stage][0]:.3e}), "
                      f"grad_norm {got['metrics']['grad_norm']:.6f} (one process "
                      f"{m0['grad_norm']:.6f}), gradients relative {dg:.3e} (tol "
                      f"{tol[stage][1]:.3e}); launches {got['launches']} expected "
                      f"{ {k: v for k, v in want.items() if k in PAR_COUNTERS} }; kernel A "
                      f"heads a launch {heads}", flush=True)
                check_launches(f"small parallel stage {stage} {shape}",
                               got["launches"], {k: want[k] for k in PAR_COUNTERS})
                if not (dl <= tol[stage][0] and dg <= tol[stage][1]):
                    raise AssertionError(f"small parallel stage {stage} mesh {shape} rank {r} "
                                         "disagrees with the one-process step")
                for k, v in got["launches"].items():
                    total[k] = total.get(k, 0) + v
    return total, tol[2][1]


def cli_rank_main(argv):
    """A rank of phase 18: python3 chip_smoke.py --cli-rank OUT SERVE_DIR --
    <main2 arguments>, started with torchrun's variables: main2.main (its
    own maybe_initialize joins the group) with the four kernels counted,
    the gradient all-reduce timed and the peak memory read; then, on the
    group main2 made, the serving scenario of SERVE_DIR (one request over a
    (1, world) mesh). Saves OUT.RANK.pt."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from audio_motion_avatar_tpu_torch import main2
    from audio_motion_avatar_tpu_torch.ops import attention as at
    from audio_motion_avatar_tpu_torch.ops import splat_tiles as st
    from audio_motion_avatar_tpu_torch.parallel import mesh as pmesh

    out, serve_dir, args = argv[0], argv[1], argv[argv.index("--") + 1:]
    rank = int(os.environ["RANK"])
    dev = torch.device(args[args.index("--device") + 1])
    cuda = dev.type == "cuda"
    reduce_s, average = [], pmesh.average_over_data

    def timed(tensors, mesh):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = average(tensors, mesh)
        if cuda:
            torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t0)
        return res

    pmesh.average_over_data = timed
    fns = (at.attention, at.attention_bwd, st.composite_tiles, st.composite_tiles_bwd)
    for fn in fns:
        fn.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    summary = main2.main(args)
    res = {"steps": summary["steps"], "launches": {fn.__name__: fn.launches for fn in fns},
           "reduce_s": reduce_s, "peak": torch.cuda.max_memory_allocated() if cuda else 0}
    pmesh.average_over_data = average
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    res["serve"] = serve_rank(serve_dir, dist.get_world_size(), dev)
    torch.save(res, f"{out}.{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def serve_rank(d, world, dev):
    """Phase 18(b) on one rank: phase 4's serving model (its config and
    seeded weights, bf16) over a (1, world) mesh, phase 4's tokens and
    first request from d/inputs.pt: the frames (rank 0), the ms of the
    request, kernel A's launches and their (B, H, S, D) shapes."""
    import torch
    import torch.distributed as dist
    from audio_motion_avatar_tpu_torch.ops import attention as at
    from audio_motion_avatar_tpu_torch.parallel import mesh as pmesh
    from audio_motion_avatar_tpu_torch.serve import build_rollout

    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    t0 = time.perf_counter()
    roll = build_rollout(inp["cfg"], device=dev, state_dict=inp["state_dict"],
                         smplx_model=inp["body"], mesh=pmesh.make_mesh(1, world))
    build_s = time.perf_counter() - t0
    tri, smpl, audio = (inp[k].to(dev) for k in ("tri", "smpl", "audio"))
    cams = {k: v.to(dev) for k, v in inp["cams"].items()}
    shapes = []
    at.attention.launches = 0
    dist.barrier()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    with torch.no_grad(), head_shapes(shapes):
        frames, next_tri, next_smpl, _ = roll(tri, smpl, audio, cams)
    sync()
    ms = 1e3 * (time.perf_counter() - t0)
    main = dist.get_rank() == 0
    return {"frames": frames.float().cpu() if main else None, "ms": ms,
            "next": (next_tri.float().cpu(), next_smpl.float().cpu()) if main else None,
            "build_s": build_s, "launches": at.attention.launches, "shapes": shapes,
            "sharded": sum(p.numel() for k, p in roll.model.named_parameters()
                           if k in pmesh.model_parallel_table(roll.model)),
            "peak": torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0}


def serving_inputs(roll, tri, smpl, req, body=None):
    """Phase 4's serving model and first request for phase 18(b), on the
    CPU: its config and seeded weights, the body it was built with (None:
    build_rollout's default), the initial tokens, the request and the frames
    phase 4's one-process rollout answers it with."""
    import torch
    audio, cams = req
    with torch.no_grad():
        frames, next_tri, next_smpl, _ = roll(tri, smpl, audio, cams)
        # the streams one at a time: the card's own rounding of differently
        # shaped products, the yardstick of phase 18(b)
        rows = torch.cat([roll(tri[i:i + 1], smpl[i:i + 1], audio[i:i + 1],
                               {k: v[i:i + 1] for k, v in cams.items()})[0]
                          for i in range(tri.shape[0])])
    mean, mx, _, psnr = frames_distance(rows, frames)
    print(f"[rollout] the request's streams served one at a time against both at once: "
          f"mean|diff| {mean:.3e}, max|diff| {mx:.3e}, PSNR {psnr:.2f} dB", flush=True)
    return {"cfg": roll.model.cfg, "body": body, "next_tri": next_tri.float().cpu(),
            "rows": rows.float().cpu(),
            "next_smpl": next_smpl.float().cpu(),
            "state_dict": {k: v.cpu() for k, v in roll.model.state_dict().items()},
            "tri": tri.cpu(), "smpl": smpl.cpu(), "audio": audio.cpu(),
            "cams": {k: v.cpu() for k, v in cams.items()}, "frames": frames.float().cpu()}


def full_parallel(dev, phase14, serving, grad_bound, extra=()):
    """18: (a) `main2 --mode train` with training.devices=2 on phase 14's
    clip (its 22 frames, 2 steps, the YAML's B = 2 global, 1 a rank), two
    processes on the card started with torchrun's variables and
    --dist-backend gloo --device cuda:0: the first step's loss and grad_norm
    held to phase 14's first step on the same global batch: grad_norm
    within 18a's stage-2 gradient bound (relative), the loss within 3x
    the relative distance phase 14 measured between that batch's loss as
    one batch of 2 and as two of 1 (the card's own bf16 rounding of the
    shapes two data ranks compute), and within 1e-5 of the latter (what the
    ranks compute, in one process); per rank the ms a step, the gradient
    all-reduce's seconds a step, the peak memory, the launches (as the local
    batch implies), the cache depth a step. (b) on the same two processes,
    one serving request at the serving width over (1, 2) (phase 4's seeded
    model, tokens and first request): its frames held to phase 4's, mean
    |diff| <= 1e-2 (frames_close's) and the mean squared difference within
    3x that of the same request's streams served one at a time in one
    process (serving_inputs: the card's own rounding of differently shaped
    products; frames_close's fixed 40 dB is printed, not required: the AR
    rollout carries a rounding change through its 48 transformer layers),
    the next token windows' distance, kernel A's launches and shapes a rank
    (the local heads).
    The times are correctness context: two ranks share one card and gloo
    crosses the host. Returns the ranks' launches (both parts, summed)."""
    import shutil

    import torch
    from audio_motion_avatar_tpu_torch.configs import ConfigLoader
    from audio_motion_avatar_tpu_torch.configs.build import build_avatar_config

    tag = "full parallel"
    if dev.type == "cuda":
        torch.cuda.empty_cache()      # the card's memory for the ranks
    config = os.path.join(PORT_CONFIGS, "config_stage_2.yaml")
    root, out = os.path.join(CLI_DIR, "ted"), os.path.join(PAR_DIR, "stage2_dp")
    serve_dir = os.path.join(PAR_DIR, "serve")
    for p in (out, serve_dir):
        shutil.rmtree(p, ignore_errors=True)
    os.makedirs(serve_dir)
    torch.save(serving, os.path.join(serve_dir, "inputs.pt"))
    over = ["model.compute_dtype=bfloat16", f"dataset.root_dir={root}",
            f"dataset.wav2vec2_model_path={os.path.join(DEMO_DIR, 'wav2vec2_base')}",
            "training.max_epochs=1", "training.cache_replacement_prob=1.0",
            "training.logging.log_every_n_steps=1", f"training.output_dir={out}",
            "training.devices=2", CLI_VIT, *extra]
    port = str(free_port())
    me = os.path.abspath(__file__)
    res_base = os.path.join(PAR_DIR, "stage2_dp_rank")
    t0 = time.perf_counter()
    procs = start_procs("stage2_dp", [[me, "--cli-rank", res_base, serve_dir, "--",
                                       "--device", "cuda:0" if dev.type == "cuda" else "cpu",
                                       "--dist-backend", "gloo",
                                       "--config", config, "--mode", "train", "--checkpoint",
                                       os.path.join(CLI_DIR, "stage2_ckpt"), *over]
                                      for _ in range(2)],
                        [{"RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": str(r),
                          "MASTER_ADDR": "localhost", "MASTER_PORT": port} for r in range(2)])
    results = wait_procs(procs, 600, tag)
    wall = time.perf_counter() - t0
    ranks_ok(results, tag)
    outs = [torch.load(f"{res_base}.{r}.pt", weights_only=False) for r in range(2)]
    ac = build_avatar_config(ConfigLoader.load_config(config, over))
    first = phase14["first"]
    batched, rowwise = phase14["rowwise"]
    # (at least 1e-6: float32's rounding of the loss itself, ~16 units)
    bound = (max(3 * abs(rowwise - batched) / abs(batched), 1e-6), grad_bound)
    total = {}
    for r, o in enumerate(outs):
        steps = o["steps"]
        m = steps[0]["metrics"]
        dl = abs(m["loss"] - first["loss"]) / abs(first["loss"])
        dg = abs(m["grad_norm"] - first["grad_norm"]) / abs(first["grad_norm"])
        drow = abs(m["loss"] - rowwise) / abs(rowwise)
        want = add_launches((train_launches(ac, 2, 1, 2, 6), len(steps)))
        want = {k: want[k] for k in PAR_COUNTERS}
        print(f"[{tag}] (a) rank {r}: {len(steps)} steps, losses "
              f"{[round(st['metrics']['loss'], 5) for st in steps]}, cache depth a step "
              f"{[st['cache_iter'] for st in steps]}; first step loss {m['loss']:.6f} grad_norm "
              f"{m['grad_norm']:.6f} against phase 14's {first['loss']:.6f} "
              f"{first['grad_norm']:.6f} (relative {dl:.3e}, {dg:.3e}; bounds {bound[0]:.3e}, "
              f"{bound[1]:.3e}); against the one-process row-wise loss {rowwise:.6f} relative "
              f"{drow:.3e} (tol 1e-5); ms a step {[round(1e3 * st['seconds'], 1) for st in steps]}, "
              f"gradient all-reduce {[round(s, 3) for s in o['reduce_s']]} s a step; peak "
              f"memory {o['peak'] / 2**30:.2f} GiB; launches {o['launches']} expected {want}",
              flush=True)
        check_launches(f"{tag} rank {r}", o["launches"], want)
        if len(steps) != 2 or not (dl <= bound[0] and dg <= bound[1] and drow <= 1e-5):
            raise AssertionError(f"{tag} (a) rank {r}: the first step disagrees with phase 14's")
        for k, v in o["launches"].items():
            total[k] = total.get(k, 0) + v
    tb = os.listdir(os.path.join(out, "tb"))
    if len(tb) != 1 or os.listdir(os.path.join(out, "checkpoints")) != ["2"]:
        raise AssertionError(f"{tag} (a): event files {tb}, checkpoints "
                             f"{os.listdir(os.path.join(out, 'checkpoints'))}")
    for r, o in enumerate(outs):
        s = o["serve"]
        heads = sorted({(sh[1], sh[2]) for sh in s["shapes"]})
        print(f"[{tag}] (b) rank {r}: serving model over (1, 2) built in {s['build_s']:.1f} s, "
              f"{s['sharded']} parameters sharded over 'model'; one request {s['ms']:.1f} ms "
              f"(the first on this model); kernel A launches {s['launches']}, (heads, sequence) "
              f"a launch {heads}; peak memory {s['peak'] / 2**30:.2f} GiB", flush=True)
        if s["launches"] <= 0 or s["sharded"] <= 0:
            raise AssertionError(f"{tag} (b) rank {r}: no kernel A launch or nothing sharded")
        total["attention"] = total.get("attention", 0) + s["launches"]
    frames = outs[0]["serve"]["frames"]
    for name, got in zip(("triplane", "SMPL-X"), outs[0]["serve"]["next"]):
        want = serving[f"next_{'tri' if name == 'triplane' else 'smpl'}"]
        print(f"[{tag}] (b) the next {name} token window against phase 4's: max|diff| "
              f"{float((got - want).abs().max()):.3e} of max|want| "
              f"{float(want.abs().max()):.3e}", flush=True)
    frames_ok(frames, f"{tag} (b)")
    got = frames_distance(frames, serving["frames"])
    own = frames_distance(serving["rows"], serving["frames"])
    print(f"[{tag}] (b) frames over (1, 2) against phase 4's one-process request: mean|diff| "
          f"{got[0]:.3e} (tol 1e-2), max|diff| {got[1]:.3e}, PSNR {got[3]:.2f} dB; the "
          f"streams served one at a time in one process against it: mean|diff| {own[0]:.3e}, "
          f"max|diff| {own[1]:.3e}, PSNR {own[3]:.2f} dB; frames_close's 40 dB "
          f"{'held' if got[3] >= 40 else 'not held'}", flush=True)
    if not (got[0] <= 1e-2 and got[2] <= 3 * max(own[2], 1e-8)):
        raise AssertionError(f"{tag} (b): the frames over (1, 2) differ from phase 4's beyond "
                             "3x the card's own rounding of differently shaped products")
    print(f"[{tag}] two processes on one card, gloo across the host: {wall:.1f} s in all "
          f"(correctness context, not speed)", flush=True)
    return total


def phase(name, fn, *args, **kwargs):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def compare_serving(state, wstate, name):
    """The Winograd + splash rollout against the direct-conv rollout on the
    same tokens, request and (seeded) weights."""
    import torch
    roll, tri, smpl, (audio, cams) = state
    with torch.no_grad():
        want = roll(tri, smpl, audio, cams)[0]
        got = wstate[0](tri, smpl, audio, cams)[0]
    frames_close(got, want, name)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from audio_motion_avatar_tpu_torch import kernels
    except ImportError as e:
        # the script copied without the repository (the contract's check
        # that it fails there): no result, a nonzero exit that says why
        print(f"chip_smoke: the port's package is not beside this script ({e})",
              file=sys.stderr)
        return 3

    dev = torch.device("cuda")
    t_run = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    secs = kernels.build(verbose=True)
    print(f"[build] {len(secs)} kernels built in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})", flush=True)

    def kernel_checks():
        out = [check_splat(dev), check_quad(dev), check_attention(dev), check_tiles(dev)]
        check_attention_stage1(dev)
        return out + [check_tiles_bwd(dev), check_attention_bwd(dev), *check_winograd(dev)]

    checks = phase("2 kernels", kernel_checks)
    if "--parent" in sys.argv:
        phase("2c parent comparison", compare_parent, dev,
              sys.argv[sys.argv.index("--parent") + 1])
    phase("3 small", check_small, dev)
    roll, state, fps4 = phase("4 rollout", run_rollout, dev)
    serving = serving_inputs(*state)
    phase("5 profile", profile_rollout, *state)
    wino, wstate, _ = phase("4b serve, Winograd + splash", run_rollout, dev,
                         tag="serve, Winograd + splash", upsampler_conv="winograd",
                         audio_attn_impl="splash")
    compare_serving(state, wstate, "serve, Winograd + splash")
    del state
    phase("5b profile, Winograd + splash", profile_rollout, *wstate,
          tag="profile, Winograd + splash")
    del wstate
    phase("6 small stage 1", check_small_stage1, dev)
    rec, rec_frames, ms7 = phase("7 reconstruct", run_reconstruction, dev)
    rec_gn, gn_frames, _ = phase("7b reconstruct, winograd_gn", run_reconstruction, dev,
                              requests=2, tag="reconstruct, winograd_gn",
                              upsampler_conv="winograd_gn")
    for got, want, view in zip(gn_frames, rec_frames, ("reference", "novel")):
        frames_close(got, want, f"reconstruct, winograd_gn {view}")
    phase("8 serve from a reference", serve_from_reference, dev)
    bounds9 = phase("9 small train", check_small_train, dev)
    (train1, ms1, peak1), (train2, ms2, _) = (phase("10 train stage 1", run_train, dev, 1),
                                              phase("11 train stage 2", run_train, dev, 2))
    train_gn, ms_gn, peak_gn = phase("10b train stage 1, winograd_gn", run_train, dev, 1,
                                     conv="winograd_gn")
    print(f"[train stage 1, winograd_gn] {ms_gn:.1f} ms a micro-step, peak memory "
          f"{peak_gn / 2**30:.2f} GiB (16.70 GiB before K9b's backward kept its temporaries "
          f"small, PERF.md); phase 10 (direct convs): {ms1:.1f} ms, {peak1 / 2**30:.2f} GiB",
          flush=True)
    phase("12a small demo", check_small_demo, dev)
    phase("12 demo", full_demo, dev)
    phase("13a small CLI", check_small_cli, dev)
    phase("13 train CLI, stage 1", cli_train_stage1, dev, ms1)
    p14 = phase("14 train CLI, stage 2", cli_train_stage2, dev, ms2)
    phase("14b train CLI, stage 2, workers", cli_train_stage2_workers, dev, p14)
    demo15 = phase("15 import demo", import_demo, dev)
    idol16 = phase("16 train CLI, IDOL", cli_train_idol, dev, ms1)
    small17 = phase("17a small render forms", check_small_forms, dev)
    forms17 = phase("17 render forms", run_render_forms, dev, fps4, ms7, ms1)
    small18, grad18 = phase("18a small parallel", check_small_parallel, dev, bounds9)
    full18 = phase("18 parallel", full_parallel, dev, p14, serving, grad18)
    del serving

    # each kernel's launches on its path: S and Q in the serving rollout
    # (phase 4), K1 and A in the reconstruction (phase 7), K2 and A-bwd in
    # the two training runs (phases 10, 11), K9a and splash (kernel A) in the
    # Winograd + splash rollout (4b), K9b in the winograd_gn reconstruction
    # and training (7b, 10b); each path's counts are printed above
    # (phases 15, 16, 17a and 17 add their S, Q, A, K1, K2 and A-bwd launches)
    k9b = "winograd_conv3x3_gn_relu"
    launches = {"splat_segments": roll["composite_segments"] + demo15["composite_segments"],
                "quad_rows": roll["quad_rows"] + demo15["quad_rows"],
                "attention": rec["attention"] + demo15["attention"] + idol16["attention"],
                "splat_tiles": rec["composite_tiles"] + idol16["composite_tiles"],
                "splat_tiles_bwd": train1["composite_tiles_bwd"] + train2["composite_tiles_bwd"]
                + idol16["composite_tiles_bwd"],
                "attention_bwd": train1["attention_bwd"] + train2["attention_bwd"]
                + idol16["attention_bwd"],
                "winograd": wino["winograd_conv3x3"], "winograd_gn": rec_gn[k9b] + train_gn[k9b],
                "splash": wino["attention"]}
    for name, fn in (("splat_segments", "composite_segments"), ("quad_rows", "quad_rows"),
                     ("attention", "attention"), ("splat_tiles", "composite_tiles"),
                     ("splat_tiles_bwd", "composite_tiles_bwd"),
                     ("attention_bwd", "attention_bwd")):
        launches[name] += small17.get(fn, 0) + forms17[fn]
        # phases 18a and 18: the ranks' launches, each rank's counted in its
        # own process from 0 around its path
        launches[name] += small18.get(fn, 0) + full18.get(fn, 0)
    pallas = "audio_motion_avatar_tpu/"
    sources = {"splat_segments": ("splat_segments.cu", pallas + "ops/splat_pallas.py:503"),
               "quad_rows": ("quad_rows.cu", pallas + "ops/triplane.py:506"),
               "attention": ("attention.cu", pallas + "models/transformer.py:261"),
               "splat_tiles": ("splat_tiles.cu", pallas + "ops/splat_pallas.py:113"),
               "splat_tiles_bwd": ("splat_tiles_bwd.cu", pallas + "ops/splat_pallas.py:251"),
               "attention_bwd": ("attention_bwd.cu", pallas + "models/transformer.py:261"),
               "winograd": ("winograd.cu", pallas + "ops/winograd.py:201"),
               "winograd_gn": ("winograd.cu", pallas + "ops/winograd.py:275"),
               "splash": ("attention.cu", pallas + "models/transformer.py:314")}
    # splash is kernel A under the JAX package's splash name: A's numbers
    checks.append(dict(next(c for c in checks if c["name"] == "attention"), name="splash"))
    line = []
    for c in checks:
        src, replaces = sources[c["name"]]
        if launches[c["name"]] <= 0:
            raise AssertionError(f"kernel {c['name']} was not launched on its path")
        line.append({"name": c["name"], "route": "cuda",
                     "source": f"audio_motion_avatar_tpu_torch/csrc/{src}",
                     "replaces": replaces, "launches": launches[c["name"]],
                     "max_abs_err": c["err"], "ms": c["ms"],
                     "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                     "bound_by": c["bound_by"], "library_ms": c["library_ms"],
                     "shape": c["shape"]})
    print(f"[run] chip_smoke.py phases done in {time.perf_counter() - t_run:.1f} s", flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if "--rank" in sys.argv:
        sys.exit(rank_main(sys.argv[sys.argv.index("--rank") + 1:]))
    if "--cli-rank" in sys.argv:
        sys.exit(cli_rank_main(sys.argv[sys.argv.index("--cli-rank") + 1:]))
    sys.exit(main())
