"""Stage-1 CLI pieces shared with main2 (the JAX package's main.py).

`parse_args` and `setup_output_dirs` are the CLI's; `build_body` and
`build_everything` build the body model, the renderer statics and the
stage-1 model from a config tree (main2 builds the stage-2 model from the
same body). `main` (train / test / predict) comes with the trainer:
ROADMAP.md section 1 item 3.
"""

from __future__ import annotations

import argparse
import os

from .configs.build import build_avatar_config
from .device import resolve_device
from .models.config import AvatarConfig
from .ops import smplx as smplx_ops

TRAINER_ITEM = "ROADMAP.md section 1 item 3 (the trainer around the step)"


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
    """The run's output directories (the JAX CLI also dumps the merged
    config as YAML there; the port has no YAML writer)."""
    out = cfg.training.output_dir
    for sub in ("checkpoints", "train_images", "test_images", "target_images"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
    return out


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


def main(argv=None):
    parse_args(argv)
    raise NotImplementedError(
        f"main.py (train / test / predict) runs through the trainer, which is not "
        f"ported yet: {TRAINER_ITEM}")


if __name__ == "__main__":
    main()
