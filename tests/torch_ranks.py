"""The rank side of the port's multi-process CPU tests (no JAX here).

    python tests/torch_ranks.py DIR RANK WORLD SCENARIO [SCENARIO ...]

joins a gloo group of WORLD processes through the file DIR/rendezvous (a
file, never a port: xdist runs several groups at once), runs each SCENARIO
in turn with one torch thread, and saves {scenario: result} to
DIR/out.<RANK>.pt. A scenario's inputs, where it needs any, are in
DIR/inputs.pt (written by the test). `run_ranks` starts such a group and
returns every rank's results (`start_ranks` and `wait_ranks` apart, to
work in the test's process meanwhile).
"""

from __future__ import annotations

import copy
import os
import subprocess
import sys
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_YAML = os.path.join(ROOT, "audio_motion_avatar_tpu_torch", "configs", "config_tiny.yaml")


def start_ranks(directory, world: int, scenarios, env=None):
    """Start WORLD ranks running `scenarios`; -> their processes."""
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(directory), str(r), str(world),
         *scenarios], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, **(env or {})), cwd=ROOT) for r in range(world)]


def wait_ranks(directory, procs, timeout: float = 240.0):
    """[rank 0's results, ...]; raises with the ranks' output if one failed
    (every rank killed after `timeout` seconds)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("\n".join(f"--- rank {r} (rc {p.returncode}):\n{o[-6000:]}"
                                       for r, (p, o) in enumerate(zip(procs, outs))))
    return [torch.load(os.path.join(str(directory), f"out.{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def run_ranks(directory, world: int, scenarios, timeout: float = 240.0):
    return wait_ranks(directory, start_ranks(directory, world, scenarios), timeout)


# ---------------------------------------------------------------------------
# scenarios: (directory, rank, world) -> a picklable result
# ---------------------------------------------------------------------------

def _inputs(d):
    return torch.load(os.path.join(d, "inputs.pt"), weights_only=False)


def _cfg(**kw):
    import dataclasses

    from audio_motion_avatar_tpu_torch.models.config import AvatarConfig
    return dataclasses.replace(AvatarConfig.tiny(image_size=(32, 32)), **kw)


def _body():
    from audio_motion_avatar_tpu_torch.ops import smplx as smplx_ops
    return smplx_ops.synthetic_model(seed=0, num_verts=300)


def _trainer(stage, inp, mesh, **kw):
    from audio_motion_avatar_tpu_torch.train import build_trainer
    from audio_motion_avatar_tpu_torch.training.train_state import OptimConfig
    return build_trainer(stage, inp.get("cfg", _cfg()), device="cpu", smplx_model=_body(),
                         state_dict=inp.get("state_dict"), seed=inp.get("seed", 0),
                         optim=OptimConfig(**inp["optim"]), mesh=mesh, **kw)


def _feed_tokens(tr, tokens, mesh):
    """The frozen ViT returns the given image tokens (this data rank's rows;
    one reference frame a row)."""
    from audio_motion_avatar_tpu_torch.parallel.mesh import rows
    flat = rows(tokens, mesh)
    tr.model.sapiens_encoder.forward = lambda images: flat


def _stage1_step(d, mesh):
    """One stage-1 step on this rank's rows of the global batch: metrics,
    the full parameters after the update, the averaged gradients (full)."""
    from audio_motion_avatar_tpu_torch.data.synthetic import make_batch, to_device
    from audio_motion_avatar_tpu_torch.parallel.mesh import batch_rows
    inp = _inputs(d)
    tr = _trainer(1, inp, mesh)
    _feed_tokens(tr, inp["tokens"], mesh)
    ref, test = (make_batch(*inp[k], (32, 32), seed=inp[k + "_seed"]) for k in ("ref", "test"))
    got = tr.step(to_device(batch_rows(ref, mesh), "cpu"),
                  to_device(batch_rows(test, mesh), "cpu"))
    st = tr.state
    grads = st.gather(st.grads())
    return dict(metrics=got, state=st, tr=tr,
                params=st.gather({k: p.detach() for k, p in st.trainable.items()}),
                grads=grads)


def dp_stage1(d, rank, world):
    from audio_motion_avatar_tpu_torch.parallel.mesh import make_mesh
    out = _stage1_step(d, make_mesh(world, 1))
    return {k: out[k] for k in ("metrics", "params", "grads")}


def tp_stage1(d, rank, world):
    """A (1, 2) tensor-parallel step, its shards and moments, and the
    checkpoint rank 0 writes of it under DIR/ckpt."""
    from audio_motion_avatar_tpu_torch.parallel.mesh import make_mesh
    from audio_motion_avatar_tpu_torch.training.checkpoints import CheckpointManager
    mesh = make_mesh(world // 2, 2)
    out = _stage1_step(d, mesh)
    st = out["state"]
    full = {k: tuple(v.shape) for k, v in _inputs(d)["state_dict"].items()}
    shapes = {k: (tuple(p.shape), full[k]) for k, p in out["tr"].model.named_parameters()}
    moments = {k: (tuple(st.opt.mu[k].shape), tuple(st.opt.nu[k].shape))
               for k in st.sharded}
    CheckpointManager(os.path.join(d, "ckpt")).save(1, st)
    return dict(metrics=out["metrics"], params=out["params"], shapes=shapes,
                moments=moments, sharded=sorted(st.sharded),
                table=sorted(st.table))


def stage2_fit(d, rank, world):
    """Three stage-2 steps (batch ids 0, 12, 24: each later step hits the
    cache entry of the one before) at cache_replacement_prob 1.0 over a
    (world, 1) mesh: the losses, the cache depths and the cache."""
    from audio_motion_avatar_tpu_torch.data.synthetic import make_batch, to_device
    from audio_motion_avatar_tpu_torch.parallel.mesh import batch_rows, make_mesh
    mesh = make_mesh(world, 1) if world > 1 else None
    inp = dict(optim=dict(_inputs(d)["optim"], learning_rate=1e-5), B=2, seed=0)
    tr = _trainer(2, inp, mesh, replacement_prob=1.0)
    steps = []
    for i, bid in enumerate((0, 12, 24)):
        ref = make_batch(inp["B"], 2, (32, 32), seed=70 + i, num_expr=10)
        tgt = make_batch(inp["B"], 6, (32, 32), seed=80 + i, with_audio=True,
                         audio_dim=16, num_expr=10)
        if mesh is not None:
            ref, tgt = batch_rows(ref, mesh), batch_rows(tgt, mesh)
        steps.append(tr.step(to_device(ref, "cpu"), to_device(tgt, "cpu"), bid))
    return dict(steps=steps, store=tr.loop.cache.store)


def cli_train(d, rank, world):
    """main2 --mode train on config_tiny.yaml with training.devices=WORLD,
    one epoch of two global batches of 2, a checkpoint at its end."""
    from audio_motion_avatar_tpu_torch import main2
    out = os.path.join(d, "cli")
    res = main2.main(["--device", "cpu", "--config", TINY_YAML, "--mode", "train",
                      f"training.output_dir={out}", f"training.devices={world}",
                      "training.batch_size=2", "training.fast_dev_run=false",
                      "training.max_epochs=1", "dataset.length=2",
                      "training.cache_replacement_prob=1.0"])
    return dict(steps=res["steps"])


def tp_modules(d, rank, world):
    """Every tensor-parallel layer against its whole twin in float32 on the
    same input, forward and the gradients of the input and of every
    parameter (gathered): {module: (forward err, grad err, scale)}."""
    from audio_motion_avatar_tpu_torch.models.image_encoder import VisionTransformer
    from audio_motion_avatar_tpu_torch.models.ptv3 import PTv3Encoder
    from audio_motion_avatar_tpu_torch.models.transformer import Transformer1D
    from audio_motion_avatar_tpu_torch.models.upsampler import TriplaneUpsampler
    from audio_motion_avatar_tpu_torch.parallel import mesh as pmesh
    from audio_motion_avatar_tpu_torch.weights import init_weights

    mesh = pmesh.make_mesh(world // 2, 2)
    rng = np.random.RandomState(5)

    def t(*shape):
        return torch.tensor(rng.randn(*shape).astype(np.float32) * 0.5)

    uv = torch.tensor(rng.uniform(-0.6, 0.6, (1, 3, 40, 2)).astype(np.float32))
    cases = {
        "transformer1d": (Transformer1D(1, 4, 8, 32, context_dim=16, norm_num_groups=8),
                          (t(2, 32, 20), t(2, 3, 16))),
        "transformer1d_one_key": (Transformer1D(1, 2, 8, 32, context_dim=16,
                                                norm_num_groups=8, final_tail=5),
                                  (t(2, 32, 20), t(2, 1, 16))),
        "vit": (VisionTransformer(width=48, depth=1, heads=2, patch=8, resolution=32),
                (t(2, 3, 32, 32),)),
        "ptv3": (PTv3Encoder(in_dim=12, out_dim=16, enc_channels=(16, 32), enc_depths=(1, 1),
                             enc_heads=(2, 4), dec_channels=(16,), dec_depths=(1,),
                             dec_heads=(2,), patch_size=16),
                 (t(1, 40, 3), t(1, 40, 12))),
        "upsampler_group": (TriplaneUpsampler(32, 2), (t(1, 3, 32, 8, 8),)),
        "upsampler_affine": (TriplaneUpsampler(32, 2, norm_mode="affine"),
                             (t(1, 3, 32, 8, 8),)),
        "upsampler_sparse": (TriplaneUpsampler(32, 2, sparse_final=True, sparse_max_tiles=8,
                                               sparse_tile_px=8), (t(1, 3, 32, 8, 8), uv)),
    }
    out = {}
    for name, (whole, args) in cases.items():
        init_weights(whole, 3)
        with torch.no_grad():
            for p in whole.parameters():      # non-trivial norms and biases
                p.add_(torch.tensor(rng.randn(*p.shape).astype(np.float32) * 0.05))
        part = pmesh.shard_model(copy.deepcopy(whole), mesh)
        res = []
        for model in (whole, part):
            xs = [a.clone().requires_grad_() for a in args]
            y = model(*xs)
            y = y.tiles if hasattr(y, "tiles") else y
            (y.float() * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
            grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
            if model is part:
                grads = pmesh.gather_params(grads, pmesh.model_parallel_table(part), mesh)
            grads.update({f"input{i}": x.grad for i, x in enumerate(xs) if x.grad is not None})
            res.append((y.detach().float(), grads))
        (y0, g0), (y1, g1) = res
        assert set(g0) == set(g1), set(g0) ^ set(g1)
        gerr = max(float((g1[k] - g0[k]).abs().max()) for k in g0)
        gscale = max(float(g.abs().max()) for g in g0.values())
        out[name] = (float((y1 - y0).abs().max()), gerr, float(y0.abs().max()), gscale,
                     len(pmesh.model_parallel_table(part)))
    return out


def _serve_mesh(d, world, cfg):
    """The serving rollout over a (2, world / 2) mesh against the one-process
    rollout on the same seeded weights and inputs (both built here), two
    chunks (the token window slid between them)."""
    from audio_motion_avatar_tpu_torch.parallel.mesh import make_mesh
    from audio_motion_avatar_tpu_torch.serve import build_rollout, synthetic_inputs
    from audio_motion_avatar_tpu_torch.weights import perturb_heads
    mesh = make_mesh(2, world // 2)
    single = build_rollout(cfg, "cpu", smplx_model=_body(), seed=4)
    perturb_heads(single.model)
    state = {k: v.clone() for k, v in single.model.state_dict().items()}
    sharded = build_rollout(cfg, "cpu", smplx_model=_body(), state_dict=state, mesh=mesh)
    tri, smpl, audio, cams = synthetic_inputs(cfg, 2, "cpu", seed=1)
    audio = torch.cat([audio, audio.flip(1)], 1)
    cams = {k: torch.cat([v, v], 1) for k, v in cams.items()}
    want = single.chunks(tri, smpl, audio, cams, 2)
    got = sharded.chunks(tri, smpl, audio, cams, 2)
    n_sharded = sum(p.numel() < single.model.get_parameter(k).numel()
                    for k, p in sharded.model.named_parameters())
    return dict(want=want[0], got=got[0], want_tri=want[1], got_tri=got[1],
                n_sharded=n_sharded)


def serve_mesh(d, rank, world):
    return _serve_mesh(d, world, _cfg())


def serve_mesh_profile(d, rank, world):
    """The serving profile (the sparse upsampler with the affine norm, the
    segmented splat, the quad sampler, tanh GELU)."""
    from audio_motion_avatar_tpu_torch.models.config import serving_config
    return _serve_mesh(d, world, serving_config(_cfg(), upsampler_norm="affine"))


SCENARIOS = {f.__name__: f for f in (dp_stage1, tp_stage1, stage2_fit, cli_train,
                                     tp_modules, serve_mesh, serve_mesh_profile)}


def main(argv):
    d, rank, world, names = argv[0], int(argv[1]), int(argv[2]), argv[3:]
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(d, 'rendezvous')}",
                            rank=rank, world_size=world)
    try:
        results = {name: SCENARIOS[name](d, rank, world) for name in names}
        torch.save(results, os.path.join(d, f"out.{rank}.pt"))
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
