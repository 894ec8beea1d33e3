"""Stage-1 CLI: train / test / predict the reconstruction model (the JAX
package's main.py).

    python -m audio_motion_avatar_tpu_torch.main --config <yaml> \
        --mode train|test|predict [--checkpoint DIR|FILE] [--resume] \
        [--device cuda|cuda:N|cpu] [--dist-backend nccl|gloo] [overrides a.b=c ...]

    torchrun --nproc_per_node N -m audio_motion_avatar_tpu_torch.main ... \
        training.devices=D training.model_parallel=M      (D x M = N)

train runs training/trainer.Trainer.fit over the dataset's train and val
splits (the train, eval and render functions of training/stage1.py); test
and predict run Trainer.validate over the val split (the train split when
it is empty) and write the comparison PNGs under test_images/. The merged
config is written to <training.output_dir>/config.yaml. It runs on the
card unless --device cpu is given (the kernels' plain versions); without a
card, cuda raises. --checkpoint DIR restores a
training/checkpoints.CheckpointManager directory; --checkpoint FILE imports
a reference Lightning .ckpt (training/torch_import.py: every structurally
identical module, non-strict; the upsampler norm defaults to 'affine' for
its folded BatchNorms). `build_body`, `build_everything` and
`load_checkpoint` are shared with main2.

Several processes, one a card (torchrun's variables, or the JAX package's
JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, or
training.multihost; parallel/distributed.py), run one
('data', 'model') mesh of training.devices x training.model_parallel
(parallel/mesh.py): the train split's global batch split over 'data', the
annotated layers over 'model'; rank 0 writes the files. --dist-backend gloo
joins over gloo with CUDA tensors (several ranks on one card; NCCL
refuses that), nccl is the card's default and gloo the CPU's.
"""

from __future__ import annotations

import argparse
import os

from .configs.build import build_avatar_config
from .device import resolve_device
from .models.config import AvatarConfig
from .ops import smplx as smplx_ops


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Stage 1: triplane avatar reconstruction")
    p.add_argument("--config", type=str,
                   default=os.path.join(os.path.dirname(__file__), "configs",
                                        "config_stage_1.yaml"))
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "test", "predict"])
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; cuda:LOCAL_RANK in a multi-process run), "
                        "cuda:N, or cpu: the plain versions of the kernels")
    p.add_argument("--dist-backend", type=str, default=None, choices=["nccl", "gloo"],
                   help="a multi-process run's backend (default nccl on the card, "
                        "gloo on the CPU)")
    p.add_argument("overrides", nargs="*", help="dotted config overrides a.b=c")
    return p.parse_args(argv)


def setup_output_dirs(cfg):
    """The run's output directories, and the merged config written there as
    config.yaml (by rank 0 of a multi-process run)."""
    from .configs import yaml_subset
    from .parallel.distributed import is_main
    out = cfg.training.output_dir
    for sub in ("checkpoints", "train_images", "test_images", "target_images"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
    if is_main():
        with open(os.path.join(out, "config.yaml"), "w") as f:
            f.write(yaml_subset.dump(cfg.to_dict()))
    return out


def start_processes(cfg, args, with_mesh: bool = True):
    """The multi-process runtime (parallel/distributed.maybe_initialize,
    binding --device and --dist-backend) and, with_mesh, the run's mesh
    (None without)."""
    from .parallel.distributed import is_main, maybe_initialize, world_size
    from .parallel.mesh import mesh_from_config
    maybe_initialize(cfg, backend=args.dist_backend, device=args.device)
    if not with_mesh:
        return None
    mesh, world = mesh_from_config(cfg), world_size()
    if is_main():
        print(f"[mesh] {mesh} over {world} process{'es' if world > 1 else ''}")
    return mesh


def load_checkpoint(path: str, state, ac: AvatarConfig, stage: int, tag: str):
    """--checkpoint: a directory restores a CheckpointManager step into
    `state`; a file is a reference torch / Lightning .ckpt, imported into
    state.model (stage 1: the TriplaneGaussianAvatar tree, stage 2: the
    AudioDrivenAvatar one). Prints what it did, as the JAX CLIs do; returns
    the state."""
    if os.path.isdir(path):
        from .training.checkpoints import CheckpointManager
        state, ok = CheckpointManager(path).restore(state)
        print(f"[{tag}] checkpoint restore: {'ok' if ok else 'none found'}")
        return state
    from .training.torch_import import import_reference_checkpoint, merge_into
    partial, report = import_reference_checkpoint(path, ac, stage=stage)
    mismatches = merge_into(state.model, partial, shard=state.shard)
    print(f"[{tag}] torch import: {report['loaded']} tensors from "
          f"{report['total_torch_modules']} torch modules; "
          f"skipped={sorted(report['skipped_modules'])[:8]}"
          f"{'...' if len(report['skipped_modules']) > 8 else ''}; "
          f"mismatches={mismatches[:8]}")
    return state


def build_body(cfg, ac: AvatarConfig) -> smplx_ops.SmplxModel:
    """The SMPL-X body (numpy): the released model when
    model.triplane_net.smplx_model_path exists, else the synthetic stand-in
    (400 vertices on the tiny profile)."""
    path = ac.smplx_model_path
    if path and os.path.exists(str(path)):
        return smplx_ops.load_model(str(path), num_expr=ac.num_expression_coeffs)
    nv = 400 if cfg.get("profile") == "tiny" else smplx_ops.SMPLX_NUM_VERTS
    print("[main] SMPLX asset not found -> synthetic body model "
          f"({nv} verts). Set model.triplane_net.smplx_model_path for parity.")
    return smplx_ops.synthetic_model(seed=0, num_verts=nv)


def build_everything(cfg, device=None):
    """Config -> (stage-1 model on `device`, seeded, eval mode; statics;
    avatar config). The stage-1 model's weights are allocated here: main2
    uses build_body instead and builds the stage-2 model around its own."""
    from .models.avatar import TriplaneGaussianAvatar
    from .models.renderer import build_renderer_statics
    from .serve import num_verts_encoder
    from .weights import init_weights

    device = resolve_device(device)
    ac = build_avatar_config(cfg)
    body = build_body(cfg, ac)
    statics = build_renderer_statics(body, device, subdivide_steps=ac.subdivide_steps,
                                     densify=ac.densify_smplx_verts)
    model = TriplaneGaussianAvatar(ac, num_verts_encoder(body))
    init_weights(model, 0)
    return model.to(device).eval(), statics, ac


def init_state(model, cfg, mesh=None):
    """The train state around the model (sharded over the mesh's 'model'
    axis first): the optimizer of the YAML's training section over every
    parameter but the frozen ViT."""
    from .configs.build import build_optim_config
    from .parallel.mesh import shard_model
    from .training.train_state import TrainState
    if mesh is not None:
        shard_model(model, mesh)
    return TrainState(model, build_optim_config(cfg), mesh=mesh)


def main(argv=None):
    """Run the CLI; returns the validation metrics of test / predict (None
    after train)."""
    import numpy as np

    from .configs import ConfigLoader
    from .configs.build import default_affine_norm_for_import
    from .data.factory import DatasetFactory
    from .serve import check_kernel_dtype
    from .training import stage1
    from .training.trainer import Trainer

    args = parse_args(argv)
    cfg = ConfigLoader.load_config(args.config, args.overrides)
    mesh = start_processes(cfg, args)
    cfg = default_affine_norm_for_import(cfg, args.checkpoint)
    device = resolve_device(args.device)

    np.random.seed(int(cfg.get("seed", 42)))
    setup_output_dirs(cfg)

    check_kernel_dtype(build_avatar_config(cfg), device, stage1=True)
    model, statics, ac = build_everything(cfg, device)
    state = init_state(model, cfg, mesh)
    train_data = DatasetFactory.create_dataloader(cfg, split="train", device=device,
                                                  mesh=mesh)
    val_data = DatasetFactory.create_dataloader(cfg, split="val", device=device)

    trainer = Trainer(cfg, stage1.make_train_step(model, statics, ac),
                      stage1.make_eval_step(model, statics, ac),
                      render_fn=stage1.make_render_fn(model, statics), device=device,
                      mesh=mesh)
    if args.checkpoint:
        state = load_checkpoint(args.checkpoint, state, ac, 1, "main")

    metrics = None
    if args.mode == "train":
        trainer.fit(state, train_data, val_data, resume=args.resume)
    else:
        metrics = trainer.validate(state, val_data or train_data, save_images=True)
        print("[main] eval:", {k: round(v, 5) for k, v in metrics.items()})
    print("[main] done.")
    return metrics


if __name__ == "__main__":
    main()
