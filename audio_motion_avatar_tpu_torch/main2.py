"""Stage-2 CLI: train, test and demo the audio-driven avatar (the JAX
package's main2.py).

    python -m audio_motion_avatar_tpu_torch.main2 --config <yaml> \
        --mode train|test|demo [--checkpoint DIR|FILE] [--resume] [--audio x.wav] \
        [--output x.mp4] [--prewarm] [--device cuda|cuda:N|cpu] \
        [--dist-backend nccl|gloo] [overrides a.b=c ...]

Train: the dataset's train split through training/stage2.Stage2TrainLoop
(the prediction cache at training.cache_replacement_prob), the metrics and
the per-cache-depth l1 channels logged every log_every_n_steps to
TensorBoard event files under tb/, audio_rendered_images/
audio_comparison_<step>_iter<depth>.png and ref_comparison_<step>.png
every 200 steps (every step under fast_dev_run), a checkpoint at the end
of each epoch (save_top_k kept; --resume restores the latest). Test: the
val split through make_predict_step, the mean L1 printed and
predict_results/audio_comparison_<n>.png written for the first 4 batches.
Neither applies the serving profile.

The demo: one stage-1 pass for the initial token window of two streams
(the dataset's items i % 12 == 0 and i % 12 == 1, batched as B = 2), then
the audio rollout chunk by chunk (T_out frames each), the last T_in
frames' tokens sliding into the next chunk; per-chunk L1 and SMPL-X losses
are printed, the decoded body is drawn over every frame, and the streams'
frames are interleaved into frames/, original_sequence.mp4 and
smplx_sequence.mp4 under <training.output_dir>/demo_outputs. With
model.demo_fuse_chunks = G, G chunks run in one call (the window slid
inside it, one host transfer a group): the same frames.

It runs on the card unless --device cpu is given (the kernels' plain
versions); without a card, cuda raises. On the card, 64-wide heads need
the override model.compute_dtype=bfloat16 (kernel A takes bf16).
--checkpoint DIR restores a training/checkpoints.CheckpointManager
directory; --checkpoint FILE imports the released full reference .ckpt
(`triplane_gaussian.*` and `audio_triplane.*`, training/torch_import.py).

Several processes, one a card (torchrun --nproc_per_node N, the JAX
package's JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID,
or training.multihost; see main.py): train runs the
('data', 'model') mesh of training.devices x training.model_parallel, each
data rank on its rows of the global batch, the prediction cache synced
over 'data' every step; rank 0 writes the event files, the PNGs and the
checkpoints (the full tree). test and demo run whole on every process,
rank 0 writing the files.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from .main import build_body, load_checkpoint, start_processes
from .parallel.distributed import is_main


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Stage 2: audio-driven avatar")
    p.add_argument("--config", type=str,
                   default=os.path.join(os.path.dirname(__file__), "configs",
                                        "config_stage_2.yaml"))
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "test", "demo"])
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--audio", type=str, default=None,
                   help="wav file for demo mode (synthetic tone if absent)")
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--prewarm", action="store_true",
                   help="demo mode: build the CUDA kernels (nvcc, the port's cold "
                        "start) and run one rollout, then exit")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; cuda:LOCAL_RANK in a multi-process run), "
                        "cuda:N, or cpu: the plain versions of the kernels")
    p.add_argument("--dist-backend", type=str, default=None, choices=["nccl", "gloo"],
                   help="a multi-process run's backend (default nccl on the card, "
                        "gloo on the CPU)")
    p.add_argument("overrides", nargs="*")
    return p.parse_args(argv)


def build_stage2(cfg, ac, device):
    """The stage-2 model with its stage-1 stack (for the token pass) and
    seeded weights, on `device`, as a serving Rollout."""
    from .device import compute_dtype
    from .serve import build_rollout
    return build_rollout(ac, device, dtype=compute_dtype(ac.compute_dtype),
                         smplx_model=build_body(cfg, ac), seed=0, stage1=True)


def init_state2(model, cfg, mesh=None):
    """The train state around the model (sharded over the mesh's 'model'
    axis first; its optimizer from the YAML), into which a checkpoint
    restores."""
    from .main import init_state
    return init_state(model, cfg, mesh)


def _stack_batches(a, b):
    """Two (B = 1, ...) VideoBatch items -> one B = 2 batch (numpy)."""
    def cat(x, y):
        return None if x is None else np.concatenate([np.asarray(x), np.asarray(y)], 0)

    return a._replace(video=cat(a.video, b.video),
                      smpl_parms={k: cat(v, b.smpl_parms[k]) for k, v in a.smpl_parms.items()},
                      cam_parms={k: cat(v, b.cam_parms[k]) for k, v in a.cam_parms.items()},
                      audio_features=cat(a.audio_features, b.audio_features))


def _concat_frames(batches):
    """Batches concatenated on the frame axis (a fused group's targets)."""
    def cat(xs):
        return None if xs[0] is None else np.concatenate([np.asarray(x) for x in xs], 1)

    first = batches[0]
    return first._replace(
        video=cat([b.video for b in batches]),
        smpl_parms={k: cat([b.smpl_parms[k] for b in batches]) for k in first.smpl_parms},
        cam_parms={k: cat([b.cam_parms[k] for b in batches]) for k in first.cam_parms},
        audio_features=cat([b.audio_features for b in batches]))


class _Clock:
    """Seconds by part; each reading waits for the device first."""

    def __init__(self, device):
        self.device = device
        self.seconds = {}
        self.t = time.perf_counter()

    def lap(self, name=None):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        dt, self.t = now - self.t, now
        if name is not None:
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
        return dt


def _cap_guard(ac, verts, T_g):
    """Diagnostic of the sparse upsampler's tile cap: the per-plane count of
    tiles the body covers (the cell mapping and 3 x 3 halo of the tile
    selection, from the base SMPL-X vertices), with a warning when the cap
    truncates the body."""
    res = ac.triplane_resolution * 2 ** ac.num_upsample_blocks
    grid = res // ac.upsampler_sparse_tile_px
    u = np.clip(verts / ac.radius, -1.0, 1.0)
    cell = np.clip(np.floor(
        (u + 1.0) * (grid / 2.0)
        - 0.5 / ac.upsampler_sparse_tile_px), 0, grid - 1)
    worst = 0
    for a0, a1 in ((0, 1), (0, 2), (1, 2)):
        cov = np.zeros((2 * T_g, grid + 2, grid + 2), bool)
        fi = np.repeat(np.arange(2 * T_g), verts.shape[2])
        cx = cell[..., a0].reshape(-1).astype(int)
        cy = cell[..., a1].reshape(-1).astype(int)
        for dr in range(3):
            for dc in range(3):
                cov[fi, cy + dr, cx + dc] = True
        worst = max(worst, int(cov.sum(axis=(1, 2)).max()))
    if worst > ac.upsampler_sparse_max_tiles:
        print(f"[demo] WARNING: body covers ~{worst} tiles > "
              f"sparse cap {ac.upsampler_sparse_max_tiles} — "
              f"low-priority halo tiles are being dropped; raise "
              f"upsampler_sparse_max_tiles if artifacts appear")


def run_demo(cfg, rollout, ac, audio_path, output_path, prewarm: bool = False
             ) -> Optional[dict]:
    """The two-stream demo (see the module docstring) on `rollout`'s device.
    Returns a summary: the output path, the counts of frames and overlays
    drawn, the printed losses, the mp4s written (None where skipped) and
    the seconds of each part (`chunk_seconds`: each group's rollout, the
    first with its kernel builds). With prewarm: None after one rollout."""
    from .data.factory import DatasetFactory
    from .data.synthetic import to_device
    from .models.audio_encoder import (SAMPLE_RATE, AudioFeatureExtractor,
                                       resample_linear)
    from .ops import smplx as smplx_ops
    from .utils import losses as L
    from .utils.graphics import draw_smplx_on_image
    from .utils.video import write_frames, write_mp4

    device = rollout.device
    clock = _Clock(device)
    T_out = ac.triplane_output_frames
    fps = int(cfg.dataset.get("frame_rate", 24))
    out_dir = os.path.join(cfg.training.output_dir, "demo_outputs")
    os.makedirs(out_dir, exist_ok=True)

    dataset = DatasetFactory.create_dataset(cfg, split="val", device=device)
    # the reference's batch index selection: one stream a frame phase
    idx_a = [i for i in range(0, min(320, len(dataset))) if i % 12 == 0]
    idx_b = [i for i in range(0, min(320, len(dataset))) if i % 12 == 1]
    n_chunks = min(len(idx_a), len(idx_b))
    if n_chunks == 0:
        raise ValueError("dataset too small for the two-stream demo")
    ref_a, tgt_a0, _ = dataset[idx_a[0]]
    ref_b, _, _ = dataset[idx_b[0]]
    clock.lap("data")

    # A wav replaces the dataset's audio features (stream A the even video
    # frames' features, stream B the odd ones'); with neither, a synthetic
    # tone drives the demo.
    wav_feats = None
    wav = None
    if audio_path and os.path.exists(audio_path):
        from .data.speech import load_audio
        raw, sr = load_audio(audio_path)
        wav = resample_linear(raw, sr)
    elif tgt_a0.audio_features is None:
        dur = 2.0 * n_chunks * T_out / fps
        t = np.arange(int(dur * SAMPLE_RATE), dtype=np.float32) / SAMPLE_RATE
        wav = (0.3 * np.sin(2 * np.pi * 220.0 * t)
               * (0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t))).astype(np.float32)
        print("[demo] no wav / dataset audio -> synthetic tone")
    if wav is not None:
        extractor = AudioFeatureExtractor(
            model_path=cfg.dataset.get("wav2vec2_model_path"),
            dim=ac.audio_feature_dim, device=device)
        wav_feats = extractor.features_per_video_frame(wav, 2 * n_chunks * T_out, fps)
    clock.lap("audio features")

    # the initial token window: both streams' first reference batches, B = 2
    ref = to_device(_stack_batches(ref_a, ref_b), device)
    triplanes, smpl_tokens = rollout.tokens(ref.video, ref.smpl_parms, ref.cam_parms)
    clock.lap("stage-1 tokens")

    fuse = max(1, int(ac.demo_fuse_chunks))
    faces = np.asarray(rollout.statics.smplx_model.faces)
    even_seq, odd_seq, even_smplx, odd_smplx = [], [], [], []
    n_full = n_chunks - n_chunks % fuse
    groups = [list(range(g, g + fuse)) for g in range(0, n_full, fuse)]
    groups += [[c] for c in range(n_full, n_chunks)]
    chunk_seconds, printed = [], []
    for group in groups:
        tgts = []
        for c in group:
            _, tgt_a, _ = dataset[idx_a[c]]
            _, tgt_b, _ = dataset[idx_b[c]]
            tgts.append(_stack_batches(tgt_a, tgt_b))
        tgt = tgts[0] if len(tgts) == 1 else _concat_frames(tgts)
        c, G = group[0], len(group)
        T_g = G * T_out
        if wav_feats is not None:
            base = 2 * c * T_out
            fa = wav_feats[base:base + 2 * T_g:2]         # even frames
            fb = wav_feats[base + 1:base + 2 * T_g:2]     # odd frames
            audio = np.stack([fa, fb])
        else:
            audio = tgt.audio_features
        audio = torch.as_tensor(np.ascontiguousarray(audio, np.float32), device=device)
        cams = {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
                for k, v in tgt.cam_parms.items()}
        clock.lap("data")

        rendered, triplanes, smpl_tokens, pred = rollout.chunks(
            triplanes, smpl_tokens, audio, cams, G)
        rendered = rendered.float().cpu()     # the group's one host transfer
        chunk_seconds.append(clock.lap("rollouts"))
        if group is groups[0]:
            print(f"[demo] first rollout (kernel builds at first use + exec): "
                  f"{chunk_seconds[0]:.1f}s")
            if prewarm:
                print("[demo] --prewarm: kernels built and one rollout run; exiting")
                return None

        # per-chunk evaluation losses, printed for each sub-chunk
        gt = torch.as_tensor(np.transpose(tgt.video, (0, 1, 3, 4, 2)))
        pred_cpu = {k: v.float().cpu() for k, v in pred.items()}
        parms = {k: torch.as_tensor(v) for k, v in tgt.smpl_parms.items()}
        for gi, cc in enumerate(group):
            sl_ = slice(gi * T_out, (gi + 1) * T_out)
            for b, name in ((0, "even"), (1, "odd")):
                l1 = float(L.l1_loss(rendered[b, sl_], gt[b, sl_]))
                parms_b = {k: v[b:b + 1, sl_] for k, v in parms.items()}
                pred_b = {k: v[b:b + 1, sl_] for k, v in pred_cpu.items()}
                sl = float(L.smplx_param_loss(pred_b, parms_b)[0])
                printed.append((cc, name, l1, sl))
                print(f"[demo] chunk {cc} {name}: L1={l1:.6f} SMPLX={sl:.6f}")
        clock.lap("losses")

        # the decoded body drawn over the rendered frames
        flat_pred = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in pred.items()}
        verts = smplx_ops.forward(rollout.statics.smplx_model, flat_pred,
                                  flat_hand_mean=ac.flat_hand_mean)
        verts = verts.float().cpu().numpy().reshape(2, T_g, -1, 3)
        if ac.upsampler_sparse:
            _cap_guard(ac, verts, T_g)
        transl = pred_cpu["transl"].numpy().reshape(2, T_g, 3)
        Ks = np.asarray(tgt.cam_parms["intrinsic"])
        Es = np.asarray(tgt.cam_parms["extrinsic"])
        rendered_np = rendered.numpy()
        for t in range(T_g):
            for b, (seq, sseq) in ((0, (even_seq, even_smplx)),
                                   (1, (odd_seq, odd_smplx))):
                frame = rendered_np[b, t]
                seq.append(frame)
                sseq.append(draw_smplx_on_image(
                    frame, verts[b, t], faces, Ks[b, t], Es[b, t],
                    transl=transl[b, t]))
        clock.lap("overlays")
        print(f"[demo] chunk {group[-1] + 1}/{n_chunks}")

    # interleave the streams
    combined, combined_smplx = [], []
    for i in range(len(even_seq)):
        combined.append(even_seq[i])
        combined_smplx.append(even_smplx[i])
        if i < len(odd_seq):
            combined.append(odd_seq[i])
            combined_smplx.append(odd_smplx[i])

    mux = audio_path if audio_path and os.path.exists(audio_path) else None
    out = output_path or os.path.join(out_dir, "original_sequence.mp4")
    mp4 = {"original": None, "smplx": None}
    if is_main():
        write_frames(combined, os.path.join(out_dir, "frames"))
        mp4 = {"original": write_mp4(combined, out, fps=fps, audio_path=mux),
               "smplx": write_mp4(combined_smplx,
                                  os.path.join(out_dir, "smplx_sequence.mp4"),
                                  fps=fps, audio_path=mux)}
    clock.lap("writing")
    print(f"[demo] wrote {len(combined)} frames -> {out} (+smplx_sequence)")
    return {"output": out, "frames": len(combined), "overlays": len(combined_smplx),
            "n_chunks": n_chunks, "losses": printed, "mp4": mp4,
            "seconds": clock.seconds, "chunk_seconds": chunk_seconds}


def run_train(cfg, rollout, state, resume: bool = False, mesh=None) -> dict:
    """--mode train (see the module docstring) over `mesh` (state's model
    sharded over it). Returns the steps' metrics (the cache depth as
    `cache_iter`) and seconds, each step timed until its metrics are read
    back (a read that waits for the card)."""
    from .data.factory import DatasetFactory
    from .data.synthetic import to_device
    from .training.checkpoints import CheckpointManager
    from .training.stage2 import Stage2TrainLoop, cache_depth_channels
    from .training.trainer import MetricLogger, save_comparison_image

    device, model, statics = rollout.device, rollout.model, rollout.statics
    train_data = DatasetFactory.create_dataloader(cfg, split="train", device=device,
                                                  mesh=mesh)
    loop = Stage2TrainLoop(
        model, statics, model.cfg,
        replacement_prob=float(cfg.training.get("cache_replacement_prob", 0.0)),
        mesh=mesh)
    fast = bool(cfg.training.get("fast_dev_run"))
    max_epochs = 1 if fast else int(cfg.training.max_epochs)
    out_dir = cfg.training.output_dir
    ckpt_mgr = None
    if not fast:
        ckpt_mgr = CheckpointManager(
            os.path.join(out_dir, "checkpoints"),
            max_to_keep=int(cfg.training.get("validation", {}).get("save_top_k", 3)))
        if resume:
            state, ok = ckpt_mgr.restore(state)
            print(f"[main2] resume: {'ok' if ok else 'no checkpoint'}")
    logger = MetricLogger(
        os.path.join(out_dir, "tb"), use_tb=is_main(),
        use_wandb=bool(cfg.training.get("logging", {}).get("use_wandb", False)))
    log_every = int(cfg.training.get("logging", {}).get("log_every_n_steps", 10))
    image_every = 1 if fast else 200
    images = os.path.join(out_dir, "audio_rendered_images")
    steps, step = [], 0
    for epoch in range(max_epochs):
        for ref, tgt, bid in train_data:
            t0 = time.perf_counter()
            state, metrics = loop.run_step(state, to_device(ref, device),
                                           to_device(tgt, device), bid)
            depth = int(metrics.pop("cache_iter"))
            metrics = {k: float(v) for k, v in metrics.items()}
            steps.append({"metrics": dict(metrics), "cache_iter": depth,
                          "seconds": time.perf_counter() - t0})
            metrics.update(cache_depth_channels(metrics["l1_target"], depth))
            if step % log_every == 0:
                logger.log(step, metrics, "train")
                if is_main():
                    print(f"[e{epoch} s{step}] " + " ".join(
                        f"{k}={v:.4f}" for k, v in metrics.items() if not np.isnan(v)))
            if step % image_every == 0 and is_main():
                save_comparison_image(
                    os.path.join(images, f"audio_comparison_{step}_iter{depth}.png"),
                    loop.last_rendered[0].float().cpu().numpy(),
                    np.transpose(np.asarray(tgt.video[0]), (0, 2, 3, 1)))
                if loop.last_ref_rendered is not None:
                    save_comparison_image(
                        os.path.join(images, f"ref_comparison_{step}.png"),
                        loop.last_ref_rendered[0].float().cpu().numpy(),
                        np.transpose(np.asarray(ref.video[0]), (0, 2, 3, 1)))
            step += 1
            if fast:
                break
        if ckpt_mgr is not None:
            ckpt_mgr.save(step, state)
        if fast:
            break
    logger.close()
    print("[main2] training done")
    return {"steps": steps}


def run_test(cfg, rollout) -> dict:
    """--mode test (see the module docstring) -> {"l1": mean, "batches": n}."""
    from .data.factory import DatasetFactory
    from .data.synthetic import to_device
    from .training.stage2 import make_predict_step
    from .training.trainer import save_comparison_image
    from .utils import losses as L

    device, model = rollout.device, rollout.model
    data = DatasetFactory.create_dataloader(cfg, split="val", device=device)
    pred = make_predict_step(model, rollout.statics, model.cfg)
    out_dir = os.path.join(cfg.training.output_dir, "predict_results")
    tot, n = 0.0, 0
    for ref, tgt, _ in data:
        ref, tgt = to_device(ref, device), to_device(tgt, device)
        rendered, _, _ = pred(ref, tgt)
        tgt_hwc = tgt.video.permute(0, 1, 3, 4, 2)
        tot += float(L.l1_loss(rendered, tgt_hwc))
        if n < 4 and is_main():
            save_comparison_image(os.path.join(out_dir, f"audio_comparison_{n}.png"),
                                  rendered[0].float().cpu().numpy(),
                                  tgt_hwc[0].float().cpu().numpy())
        n += 1
    print(f"[main2] test l1={tot / max(n, 1):.5f} over {n} batches")
    return {"l1": tot / max(n, 1), "batches": n}


def main(argv=None):
    """Run the CLI. Returns the demo's run_demo summary with the build's
    seconds added (None with --prewarm), run_train's or run_test's."""
    args = parse_args(argv)
    t0 = time.perf_counter()
    from .configs import ConfigLoader
    from .configs.build import (apply_serving_profile, build_avatar_config,
                                default_affine_norm_for_import)
    from .device import resolve_device

    cfg = ConfigLoader.load_config(args.config, args.overrides)
    mesh = start_processes(cfg, args, with_mesh=args.mode == "train")
    cfg = default_affine_norm_for_import(cfg, args.checkpoint)
    device = resolve_device(args.device)

    np.random.seed(int(cfg.get("seed", 42)))
    os.makedirs(cfg.training.output_dir, exist_ok=True)

    ac = build_avatar_config(cfg)
    if args.mode == "demo":
        # inference only: the serving profile's knobs unless the YAML names them
        ac = apply_serving_profile(ac, cfg)
    rollout = build_stage2(cfg, ac, device)
    state = init_state2(rollout.model, cfg, mesh)
    if args.checkpoint:
        state = load_checkpoint(args.checkpoint, state, ac, 2, "main2")
    if args.mode == "train":
        return run_train(cfg, rollout, state, resume=args.resume, mesh=mesh)
    if args.mode == "test":
        return run_test(cfg, rollout)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    if args.prewarm and device.type == "cuda":
        from . import kernels
        kernels.build()
    summary = run_demo(cfg, rollout, rollout.model.cfg, args.audio, args.output,
                       prewarm=args.prewarm)
    if summary is not None:
        summary["seconds"]["build"] = build_s
    return summary


if __name__ == "__main__":
    main()
