"""Stage-1 CLI: train / test / predict the reconstruction model (the JAX
package's main.py).

    python -m audio_motion_avatar_tpu_torch.main --config <yaml> \
        --mode train|test|predict [--checkpoint DIR] [--resume] \
        [--device cuda|cpu] [overrides a.b=c ...]

train runs training/trainer.Trainer.fit over the dataset's train and val
splits (the train, eval and render functions of training/stage1.py); test
and predict run Trainer.validate over the val split (the train split when
it is empty) and write the comparison PNGs under test_images/. The merged
config is written to <training.output_dir>/config.yaml. It runs on the
card unless --device cpu is given (the kernels' plain versions); without a
card, cuda raises. --checkpoint DIR restores a
training/checkpoints.CheckpointManager directory; a reference .ckpt file
(ROADMAP.md section 1 item 4) and multi-host or multi-device runs (item 7)
are refused. `build_body` and `build_everything` are shared with main2.
"""

from __future__ import annotations

import argparse
import os

from .configs.build import build_avatar_config
from .device import resolve_device
from .models.config import AvatarConfig
from .ops import smplx as smplx_ops

from .training.trainer import PARALLEL_ITEM

IMPORT_ITEM = "ROADMAP.md section 1 item 4 (training/torch_import.py)"


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
                   help="cuda (default) or cpu: the plain versions of the kernels")
    p.add_argument("overrides", nargs="*", help="dotted config overrides a.b=c")
    return p.parse_args(argv)


def setup_output_dirs(cfg):
    """The run's output directories, and the merged config written there as
    config.yaml."""
    from .configs import yaml_subset
    out = cfg.training.output_dir
    for sub in ("checkpoints", "train_images", "test_images", "target_images"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
    with open(os.path.join(out, "config.yaml"), "w") as f:
        f.write(yaml_subset.dump(cfg.to_dict()))
    return out


def refuse_multihost(cfg) -> None:
    """The JAX CLIs initialize a multi-process runtime when the config or
    the environment asks for one; the port has none yet."""
    want = os.environ.get("AMA_MULTIHOST", "") not in ("", "0", "false")
    want = want or bool(os.environ.get("JAX_COORDINATOR_ADDRESS"))
    training = cfg.get("training") or {}
    if want or bool(training.get("multihost", False)):
        raise NotImplementedError(
            f"a multi-host run (training.multihost, AMA_MULTIHOST or "
            f"JAX_COORDINATOR_ADDRESS) is not ported yet: {PARALLEL_ITEM}")


def refuse_checkpoint_file(path) -> None:
    if path and not os.path.isdir(path):
        raise NotImplementedError(
            f"--checkpoint {path!r} is a file: importing a reference .ckpt is not "
            f"ported yet ({IMPORT_ITEM}); a CheckpointManager directory restores")


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


def init_state(model, cfg):
    """The train state around the model: the optimizer of the YAML's
    training section over every parameter but the frozen ViT."""
    from .configs.build import build_optim_config
    from .training.train_state import TrainState
    return TrainState(model, build_optim_config(cfg))


def main(argv=None):
    """Run the CLI; returns the validation metrics of test / predict (None
    after train)."""
    import numpy as np

    from .configs import ConfigLoader
    from .configs.build import default_affine_norm_for_import
    from .data.factory import DatasetFactory
    from .serve import check_kernel_dtype
    from .training import stage1
    from .training.trainer import Trainer, refuse_parallel

    args = parse_args(argv)
    cfg = ConfigLoader.load_config(args.config, args.overrides)
    refuse_multihost(cfg)
    refuse_checkpoint_file(args.checkpoint)
    cfg = default_affine_norm_for_import(cfg, args.checkpoint)
    refuse_parallel(cfg)
    device = resolve_device(args.device)

    np.random.seed(int(cfg.get("seed", 42)))
    setup_output_dirs(cfg)

    check_kernel_dtype(build_avatar_config(cfg), device, stage1=True)
    model, statics, ac = build_everything(cfg, device)
    state = init_state(model, cfg)
    train_data = DatasetFactory.create_dataloader(cfg, split="train", device=device)
    val_data = DatasetFactory.create_dataloader(cfg, split="val", device=device)

    trainer = Trainer(cfg, stage1.make_train_step(model, statics, ac),
                      stage1.make_eval_step(model, statics, ac),
                      render_fn=stage1.make_render_fn(model, statics), device=device)
    if args.checkpoint:
        from .training.checkpoints import CheckpointManager
        state, ok = CheckpointManager(args.checkpoint).restore(state)
        print(f"[main] checkpoint restore: {'ok' if ok else 'none found'}")

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
