#!/usr/bin/env python3
"""The stage-1 triplane segment mean (ops/triplane.scatter_mean_plane)
against an earlier tree's, on one NVIDIA GPU (H100), in one process;
chip_smoke.py is the check of record.

    python3 segment_mean_probe.py --parent DIR

DIR holds an earlier tree (git archive). Its scatter_mean_plane is compiled
from DIR/audio_motion_avatar_tpu_torch/ops/triplane.py and swapped into this
tree's module in turns (parent, this tree, this tree, parent) for:
  the op alone, on the inputs of the first of its three calls in the
     triplane encoder of chip_smoke's phase 7 (the full-width bf16
     reconstruction: AvatarConfig(), B = 1, a 1024^2 reference view):
     CUDA-event mean of 50 calls, forward alone and forward + backward,
     each version's max|diff| from this tree's;
  phase 7's triplane-encoder stage (model.smplx_triplane_encoder on phase
     7's request, no grad): host clock with a sync either side, median of 10;
  phase 10's stage-1 micro-step (AvatarConfig(), bf16, B = 1, a 1024^2
     reference view and 8 test views, train_stage1.yaml's optimizer through
     chip_smoke.seeded_trainer): host clock as phase 10, the median and the
     range of 8 (two updates), and the mean's calls a micro-step.
First it runs each version's forward, then its backward, under
torch.cuda.set_sync_debug_mode("error") and prints the host syncs each
makes (and, as a control, those of torch.bincount of the cell ids); it
fails if this tree's forward makes one. Prints the card's name and power
limit first.
"""

import ast
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TURNS = ("parent", "this tree", "this tree", "parent")


def parent_mean(parent):
    """scatter_mean_plane as DIR's ops/triplane.py defines it."""
    import torch
    path = os.path.join(parent, "audio_motion_avatar_tpu_torch", "ops", "triplane.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "scatter_mean_plane")
    ns = {"torch": torch}
    exec(compile(ast.Module([fn], []), path, "exec"), ns)
    return ns["scatter_mean_plane"]


def syncs(fn, args):
    """The first host sync of fn's forward and of its backward (None: none;
    the backward is not run after a forward that synced)."""
    import torch

    def first(run):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run(), None
        except RuntimeError as e:
            return None, str(e).splitlines()[0][:160]
        finally:
            torch.cuda.set_sync_debug_mode("default")

    values = args[0].detach().clone().requires_grad_(True)
    out, fwd = first(lambda: fn(values, *args[1:]))
    if fwd is not None or not out.requires_grad:
        return fwd, "not run"
    return fwd, first(lambda: out.float().sum().backward())[1]


def event_ms(fn, iters=50):
    """CUDA-event mean of fn over iters calls, after one."""
    import torch
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters, spread=False):
    """Host-clock median of fn over iters calls, a sync either side (with
    spread: the median, the least and the most)."""
    import torch
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    med = statistics.median(times)
    return (med, min(times), max(times)) if spread else med


def in_turns(versions, fn):
    """fn() under each version in TURNS order: a list of its results."""
    from audio_motion_avatar_tpu_torch.ops import triplane
    own = triplane.scatter_mean_plane
    out = []
    try:
        for name in TURNS:
            triplane.scatter_mean_plane = versions[name]
            out.append(fn())
    finally:
        triplane.scatter_mean_plane = own
    return out


def show(tag, times):
    """One line: each turn's time (or median [least, most])."""
    fmt = (lambda t: f"{t:.3f}") if not isinstance(times[0], tuple) else \
        (lambda t: f"{t[0]:.1f} [{t[1]:.1f}, {t[2]:.1f}]")
    print(f"[{tag}] " + ", ".join(f"{n} {fmt(t)}" for n, t in zip(TURNS, times)) + " ms",
          flush=True)


def main():
    import torch
    if not torch.cuda.is_available() or "--parent" not in sys.argv:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from audio_motion_avatar_tpu_torch import kernels
    from audio_motion_avatar_tpu_torch.data.synthetic import make_batch, to_device
    from audio_motion_avatar_tpu_torch.models.config import AvatarConfig
    from audio_motion_avatar_tpu_torch.ops import triplane
    from audio_motion_avatar_tpu_torch.reconstruct import build_reconstructor
    from audio_motion_avatar_tpu_torch.train import STAGE1_OPTIM
    from audio_motion_avatar_tpu_torch.weights import perturb_heads

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels.build()
    versions = {"parent": parent_mean(sys.argv[sys.argv.index("--parent") + 1]),
                "this tree": triplane.scatter_mean_plane}

    cfg = AvatarConfig()
    H, W = cfg.image_size
    rec = build_reconstructor(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    perturb_heads(rec.model, seed=1, std=1e-2)
    cs.visible_heads(rec.model, scale_bias=-1.0, opacity_bias=0.0)
    model, statics = rec.model, rec.statics
    ref = to_device(make_batch(1, 1, (H, W), seed=0), dev)
    calls = []
    own = triplane.scatter_mean_plane

    def spy(*args):
        calls.append(args)
        return own(*args)

    with torch.no_grad():
        image_tokens = model.sapiens_encoder(ref.video[:, 0])[:, None]
        feats = model.image_feature(ref.video, image_tokens)

        def encoder():
            return model.smplx_triplane_encoder(statics.smplx_model, image_tokens,
                                                ref.cam_parms, ref.smpl_parms,
                                                feats.reshape((1,) + feats.shape[2:]))
        triplane.scatter_mean_plane = spy
        try:
            encoder()
        finally:
            triplane.scatter_mean_plane = own
        args = calls[0]
        v, idx, R = args
        cells = torch.bincount(idx.reshape(-1), minlength=R * R)
        print(f"[segment mean] {len(calls)} calls an encoder forward; the first: values "
              f"{tuple(v.shape)} {v.dtype}, R = {R}, {int((cells > 0).sum())} cells hold "
              f"points, the most {int(cells.max())}", flush=True)
        want = own(*args)
        for name in ("parent", "this tree"):
            got = versions[name](*args)
            print(f"[segment mean] {name}: max|diff| from this tree's "
                  f"{float((got.float() - want.float()).abs().max()):.3e}", flush=True)
    for name in ("parent", "this tree"):
        fwd, bwd = syncs(versions[name], args)
        print(f"[segment mean] {name}: host sync in the forward {fwd}; in the backward {bwd}",
              flush=True)
        if name == "this tree" and fwd is not None:
            raise AssertionError(f"this tree's segment mean syncs the host: {fwd}")
    control = syncs(lambda v, i, r: torch.bincount(i.reshape(-1), minlength=r * r), args)[0]
    print(f"[segment mean] control, torch.bincount of the cell ids: host sync {control}",
          flush=True)
    v_grad = args[0].detach().clone().requires_grad_(True)
    dout = torch.randn_like(own(*args))

    def fwd_bwd():
        return torch.autograd.grad(triplane.scatter_mean_plane(v_grad, *args[1:]), v_grad, dout)

    with torch.no_grad():
        show("segment mean alone",
             in_turns(versions, lambda: event_ms(lambda: triplane.scatter_mean_plane(*args))))
    show("segment mean alone, forward + backward", in_turns(versions, lambda: event_ms(fwd_bwd)))
    with torch.no_grad():
        encoder()
        show("triplane encoder (phase 7's stage)", in_turns(versions, lambda: host_ms(encoder, 10)))
    del rec, model, statics, image_tokens, feats, args, v, idx, v_grad, dout
    calls.clear()
    torch.cuda.empty_cache()

    tr = cs.seeded_trainer(1, cfg, dev, torch.bfloat16, optim=STAGE1_OPTIM)
    test = to_device(make_batch(1, 8, (H, W), seed=1), dev)
    triplane.scatter_mean_plane = spy
    try:
        tr.step(ref, test, 0)
    finally:
        triplane.scatter_mean_plane = own
    print(f"[segment mean] {len(calls)} calls a micro-step", flush=True)
    show("stage-1 micro-step (phase 10's)",
         in_turns(versions, lambda: host_ms(lambda: tr.step(ref, test, 0), 8, spread=True)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
