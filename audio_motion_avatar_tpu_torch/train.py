"""Training: the port's counterpart of the train step of `main.py --mode
train` (stage 1, the reconstruction model) and of `main2.py`'s (stage 2,
the audio-driven model with the prediction-cache curriculum).

`build_trainer(stage, cfg, device, dtype)` builds the model, its renderer
statics and the train state (optimizer over every parameter but the frozen
Sapiens ViT); the returned `Trainer.step(ref_batch, test_or_target_batch,
batch_id)` runs one micro-step (forward, backward, optimizer call) and
returns its metrics as floats. On the card every D = 64 attention, the ViT
excepted, runs kernel A forward and A-bwd backward, and every tile
composite K1 forward and K2 backward; configurations that select a
forward-only kernel (the segmented splat S, the forward-only attention
names) are refused here, as the JAX package has no backward for them
either; the sparse upsampler trains with the quad sampler (kernel Q
forward, Q-bwd backward), the 4-tap or the slab sampler. The CLIs' epoch loop, logging and checkpoints are
training/trainer.py's (main.py, main2.py). Over a mesh (parallel/mesh.py)
the model is sharded over 'model' after its weights are loaded, each data
rank steps on its rows of the global batch (mesh.batch_rows), and the
metrics are the global batch's.
"""

from __future__ import annotations

from typing import Optional

import torch

from .data.synthetic import VideoBatch
from .device import resolve_device
from .models.audio_avatar import AudioDrivenAvatar
from .models.avatar import TriplaneGaussianAvatar
from .models.config import AvatarConfig
from .models.renderer import build_renderer_statics
from .ops import smplx as smplx_ops
from .parallel import mesh as pmesh
from .serve import check_kernel_dtype, num_verts_encoder, with_dtype
from .training import stage1, stage2
from .training.train_state import OptimConfig, TrainState, check_differentiable
from .weights import init_weights

# the optimizer sections of the JAX package's train_stage1.yaml and
# train_stage2.yaml (Adam, LinearLR to end_factor, clip 1.0)
STAGE1_OPTIM = OptimConfig(learning_rate=5e-5, total_steps=50000, end_factor=0.1,
                           grad_clip=1.0, accumulate_steps=4)
STAGE2_OPTIM = OptimConfig(learning_rate=1e-4, total_steps=100000, end_factor=0.01,
                           grad_clip=1.0, accumulate_steps=1)


class Trainer:
    """One training micro-step per `step` call, on the model's device."""

    def __init__(self, stage: int, model, statics, state: TrainState, cfg,
                 device: torch.device, replacement_prob: float = 0.0, seed: int = 0):
        self.stage, self.model, self.statics, self.state = stage, model, statics, state
        self.cfg, self.device = cfg, device
        if stage == 1:
            self._step = stage1.make_train_step(model, statics, cfg)
            self.loop = None
        else:
            self.loop = stage2.Stage2TrainLoop(model, statics, cfg, replacement_prob,
                                               seed=seed, mesh=state.mesh)

    def step(self, ref_batch: VideoBatch, test_or_target_batch: Optional[VideoBatch],
             batch_id: int = 0) -> dict:
        """Batches of tensors on the model's device (data.synthetic.to_device).
        Stage 1: the reference views and the test views (or None); stage 2:
        the reference frames and the target frames with their audio, and
        the batch id the prediction cache is keyed by. Over a mesh with data
        ranks, this rank's rows of the global batch."""
        if self.stage == 1:
            _, metrics = self._step(self.state, ref_batch, test_or_target_batch)
        else:
            _, metrics = self.loop.run_step(self.state, ref_batch,
                                            test_or_target_batch, batch_id)
        return {k: float(v) for k, v in metrics.items()}


def build_trainer(stage: int, cfg: AvatarConfig, device=None,
                  dtype: Optional[torch.dtype] = None,
                  smplx_model: Optional[smplx_ops.SmplxModel] = None,
                  seed: int = 0, optim: Optional[OptimConfig] = None,
                  state_dict: Optional[dict] = None,
                  replacement_prob: float = 0.0,
                  mesh: Optional[pmesh.Mesh] = None) -> Trainer:
    """A stage-1 (TriplaneGaussianAvatar) or stage-2 (AudioDrivenAvatar)
    trainer on `device` (CUDA unless "cpu" is asked for).

    dtype: compute dtype of the transformer / refiner / upsampler stacks
    (torch.bfloat16 on the card; None keeps cfg.compute_dtype). optim: the
    optimizer (default: the stage's YAML, STAGE1_OPTIM / STAGE2_OPTIM).
    Weights come from `state_dict` (weights.params_from_flax) or a seeded
    init. replacement_prob: stage 2's cache replacement probability. mesh:
    the process mesh (parallel/mesh.make_mesh); the full weights are loaded,
    then sharded over its 'model' axis."""
    if stage not in (1, 2):
        raise ValueError(f"stage must be 1 or 2, got {stage}")
    device = resolve_device(device)
    cfg = with_dtype(cfg, dtype)
    check_kernel_dtype(cfg, device, stage1=True)
    check_differentiable(cfg)
    if smplx_model is None:
        smplx_model = smplx_ops.synthetic_model(seed=0)
    nverts = num_verts_encoder(smplx_model)
    model = (TriplaneGaussianAvatar(cfg, nverts) if stage == 1
             else AudioDrivenAvatar(cfg, nverts))
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init_weights(model, seed)
    model.to(device)
    statics = build_renderer_statics(smplx_model, device,
                                     subdivide_steps=cfg.subdivide_steps,
                                     densify=cfg.densify_smplx_verts)
    optim = optim or (STAGE1_OPTIM if stage == 1 else STAGE2_OPTIM)
    if mesh is not None:
        pmesh.shard_model(model, mesh)
    return Trainer(stage, model, statics, TrainState(model, optim, mesh=mesh), cfg,
                   device, replacement_prob, seed)
