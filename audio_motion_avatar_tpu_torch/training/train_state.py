"""Optimizer and train state (the JAX package's training/train_state.py).

The JAX package's optax chain, step for step and in float32:

    MultiSteps(apply_if_finite(chain(clip_by_global_norm, adam(schedule))))

- clip_by_global_norm: g / ||g|| * max_norm where ||g|| >= max_norm, with no
  epsilon in the divisor (unlike torch.nn.utils.clip_grad_norm_);
- Adam: m = (1 - b1) g + b1 m, v = (1 - b2) g^2 + b2 v, the update
  m_hat / (sqrt(v_hat) + 1e-8) scaled by -lr(n) at the n-th applied update
  (n from 0; the bias correction powers by n + 1): Adam and the schedule
  count the same updates;
- AdamW where weight_decay > 0 (optax.adamw): the decay is decoupled, added
  to Adam's update as weight_decay * p for every trainable parameter (no
  mask) before the update is scaled by -lr(n), after the clip and inside
  the same guard and accumulation;
- the schedule: linear from lr to lr * end_factor over total_steps -
  warmup_steps updates, after a linear warmup from 0 when warmup_steps > 0;
- apply_if_finite (nan_guard): a non-finite gradient is skipped (zero
  update, inner state kept) and counted; once more than
  nan_guard_max_consecutive in a row were, the update is applied anyway;
- MultiSteps (accumulate_steps > 1): the running mean of the gradients
  acc + (g - acc) / (n + 1); every accumulate_steps-th call applies the
  inner update to it and clears it by a multiplication by 0 (a NaN in the
  accumulator stays, as in optax); the schedule advances once per real
  update.

Parameters under FROZEN_PREFIXES (the Sapiens encoder) carry no optimizer
state and never move. A trainable parameter without a gradient counts as a
zero gradient, as its zero cotangent does in JAX.

Over a mesh (parallel/mesh.py) the train state holds this rank's slice of
each 'model'-sharded parameter, and Adam's moments (and the accumulator)
are made beside them, so they follow their parameters. The gradients are
averaged over 'data' (every micro-step, before the clip: each micro-step's
logged grad_norm is then the global batch's, as under the JAX mesh). The
global norm, the clip and apply_if_finite see the whole tree: each sharded
leaf's sum of squares (and its count of non-finite entries) is summed over
'model', each replicated leaf counts once, so every rank takes the same
decision, the one-process one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import torch
from torch import nn

from ..models.transformer import FORWARD_ONLY_ATTN_IMPLS
from ..parallel import mesh as pmesh


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 5e-5
    total_steps: int = 50000
    end_factor: float = 0.01
    betas: tuple = (0.9, 0.999)
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    accumulate_steps: int = 1
    warmup_steps: int = 0
    nan_guard: bool = True
    nan_guard_max_consecutive: int = 10


FROZEN_PREFIXES = ("sapiens_encoder",)
ADAM_EPS = 1e-8


def is_frozen(name: str, prefixes: Iterable[str] = FROZEN_PREFIXES) -> bool:
    """A parameter name (dotted) lies under a frozen subtree."""
    parts = name.split(".")
    return any(p in parts for p in prefixes)


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _linear(init: float, end: float, steps: int, count: int) -> torch.Tensor:
    """optax.linear_schedule at `count`, in float32."""
    if steps <= 0:
        return _f32(init)
    c = min(max(count, 0), steps)
    frac = 1 - _f32(c) / steps
    return _f32(init - end) * frac + _f32(end)


def learning_rate(cfg: OptimConfig, count: int) -> torch.Tensor:
    """The schedule's learning rate at update `count` (float32 scalar)."""
    decay = (cfg.learning_rate, cfg.learning_rate * cfg.end_factor,
             cfg.total_steps - cfg.warmup_steps)
    if cfg.warmup_steps > 0 and count < cfg.warmup_steps:
        return _linear(0.0, cfg.learning_rate, cfg.warmup_steps, count)
    return _linear(*decay, count - max(cfg.warmup_steps, 0))


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def tree_stats(grads: Dict[str, torch.Tensor], sharded: frozenset = frozenset(),
               mesh: Optional["pmesh.Mesh"] = None, check_finite: bool = True):
    """(global norm, every entry finite) of a gradient tree whose `sharded`
    leaves are this rank's slices over the mesh's 'model' axis; without
    sharded leaves, global_norm and the per-leaf check (skipped, True,
    unless check_finite)."""
    axis = None if mesh is None else mesh.model_axis
    if axis is None or not sharded:
        return (global_norm(grads.values()), not check_finite or
                all(bool(torch.isfinite(g).all()) for g in grads.values()))
    rep = [g for k, g in grads.items() if k not in sharded]
    shd = [g for k, g in grads.items() if k in sharded]
    part = torch.stack([sum(torch.sum(g.float() * g.float()) for g in shd),
                        sum((~torch.isfinite(g)).sum().float() for g in shd)])
    torch.distributed.all_reduce(part, group=axis.group)
    sq = sum(torch.sum(g * g) for g in rep) + part[0]
    finite = float(part[1]) == 0 and all(bool(torch.isfinite(g).all()) for g in rep)
    return torch.sqrt(sq), finite


class Optimizer:
    """The chain above over a fixed, ordered set of named parameters;
    `sharded` names the ones that are this rank's slices over the mesh's
    'model' axis."""

    def __init__(self, cfg: OptimConfig, params: Dict[str, torch.Tensor],
                 mesh: Optional["pmesh.Mesh"] = None, sharded: frozenset = frozenset()):
        self.cfg = cfg
        self.mesh, self.sharded = mesh, sharded
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0              # applied updates
        self.notfinite_count = 0
        self.mini_step = 0
        self.acc = ({k: torch.zeros_like(p) for k, p in params.items()}
                    if cfg.accumulate_steps > 1 else None)

    def state_dict(self) -> dict:
        """The optimizer's state (tensors as they are, counters as ints)."""
        return {"mu": dict(self.mu), "nu": dict(self.nu), "acc": self.acc,
                "count": self.count, "notfinite_count": self.notfinite_count,
                "mini_step": self.mini_step}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore state_dict()'s output (its tensors copied onto the
        parameters' devices); the parameter names must match."""
        for name in ("mu", "nu") + (("acc",) if self.acc is not None else ()):
            mine, theirs = getattr(self, name), state[name]
            if theirs is None or set(theirs) != set(mine):
                raise KeyError(f"optimizer state {name!r} does not match the parameters")
            for k, v in theirs.items():
                mine[k] = v.to(device=mine[k].device, dtype=mine[k].dtype).clone()
        self.count = int(state["count"])
        self.notfinite_count = int(state["notfinite_count"])
        self.mini_step = int(state["mini_step"])

    @torch.no_grad()
    def _inner(self, grads: Dict[str, torch.Tensor],
               params: Dict[str, torch.Tensor]) -> None:
        """apply_if_finite(chain(clip, adam)) applied to params in place."""
        cfg = self.cfg
        g_norm, finite = tree_stats(grads, self.sharded, self.mesh, cfg.nan_guard)
        if cfg.nan_guard:
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            if not finite and self.notfinite_count <= cfg.nan_guard_max_consecutive:
                return
        clip = not bool(g_norm < cfg.grad_clip)
        b1, b2 = cfg.betas
        step = -learning_rate(cfg, self.count)
        self.count += 1
        bc1 = 1 - _f32(b1) ** self.count
        bc2 = 1 - _f32(b2) ** self.count
        for k, p in params.items():
            g = grads[k]
            if clip:
                g = (g / g_norm) * cfg.grad_clip
            self.mu[k] = (1 - b1) * g + b1 * self.mu[k]
            self.nu[k] = (1 - b2) * (g * g) + b2 * self.nu[k]
            upd = (self.mu[k] / bc1.to(p.device)) / (
                torch.sqrt(self.nu[k] / bc2.to(p.device)) + ADAM_EPS)
            if cfg.weight_decay > 0:
                upd = upd + cfg.weight_decay * p
            p.add_(step.to(p.device) * upd)

    @torch.no_grad()
    def apply(self, grads: Dict[str, torch.Tensor],
              params: Dict[str, torch.Tensor]) -> bool:
        """One call of the optax update + apply_updates. Returns whether the
        parameters took an update (False on an accumulation mini-step)."""
        k = self.cfg.accumulate_steps
        if k <= 1:
            self._inner(grads, params)
            return True
        n = self.mini_step
        for name, g in grads.items():
            self.acc[name] = self.acc[name] + (g - self.acc[name]) / (n + 1)
        emit = n == k - 1
        if emit:
            self._inner(self.acc, params)
            for name in self.acc:
                self.acc[name] = self.acc[name] * 0
        self.mini_step = (n + 1) % k
        return emit


class TrainState:
    """The model, its step count and the optimizer over the trainable
    (not frozen) parameters; over a mesh, the model already sharded
    (parallel/mesh.shard_model)."""

    def __init__(self, model: nn.Module, optim: OptimConfig,
                 prefixes: Iterable[str] = FROZEN_PREFIXES,
                 mesh: Optional["pmesh.Mesh"] = None):
        self.model = model
        self.step = 0
        self.mesh = mesh or pmesh.Mesh(1, 1)
        self.table = (pmesh.model_parallel_table(model)
                      if self.mesh.model_axis is not None else {})
        self.trainable = {k: p for k, p in model.named_parameters()
                          if not is_frozen(k, prefixes)}
        self.frozen = {k: p for k, p in model.named_parameters()
                       if is_frozen(k, prefixes)}
        self.sharded = frozenset(k for k in self.trainable if k in self.table)
        self.opt = Optimizer(optim, self.trainable, self.mesh, self.sharded)

    def grads(self) -> Dict[str, torch.Tensor]:
        """The trainable parameters' gradients (zeros where none flowed),
        averaged over the mesh's data ranks."""
        return pmesh.average_over_data(
            {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in self.trainable.items()}, self.mesh)

    def grad_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole gradient tree (grad_norm's metric)."""
        return tree_stats(grads, self.sharded, self.mesh, check_finite=False)[0]

    def global_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This data rank's metrics -> the global batch's (mesh.reduce_metrics)."""
        return pmesh.reduce_metrics(metrics, self.mesh)

    def gather(self, tree: Optional[Dict[str, torch.Tensor]]):
        """A {parameter name: tensor} tree of this rank's slices -> the full
        tensors (a collective over 'model'; the identity without it)."""
        return None if tree is None else pmesh.gather_params(tree, self.table, self.mesh)

    def shard(self, tree: Optional[Dict[str, torch.Tensor]]):
        """A full {parameter name: tensor} tree -> this rank's slices."""
        if tree is None or self.mesh.model_axis is None:
            return tree
        return pmesh.shard_state_dict(tree, self.table, self.mesh.num_model,
                                      self.mesh.model_rank)

    def zero_grad(self) -> None:
        for p in self.model.parameters():
            p.grad = None

    def apply_gradients(self, grads: Optional[Dict[str, torch.Tensor]] = None) -> bool:
        """Update the trainable parameters from `grads` (default: their
        .grad); returns whether an update was applied."""
        self.step += 1
        return self.opt.apply(self.grads() if grads is None else grads,
                              self.trainable)


# where the quad sampler's training (a backward for kernel Q) is queued
QUAD_TRAINING_ITEM = "ROADMAP.md section 1 item 9 (training with sample_quad)"


def check_differentiable(cfg) -> None:
    """Refuse, when a training step is built, the options that select a
    forward-only kernel: the segmented splat (kernel S), the quad sampling
    of the sparse upsampler (kernel Q; QUAD_TRAINING_ITEM) and the JAX
    package's forward-only attention kernels (audio_attn_impl flash2,
    splash, serve, hpack). sample_quad selects Q only where the renderer
    reads it, on the sparse upsampler; the dense path ignores it. Everything
    else trains by autograd: the sparse upsampler with the 4-tap or slab
    sampler, the Winograd convs (their backward is the direct conv's), SH
    colours."""
    quad = cfg.sample_quad and cfg.upsample_triplane and cfg.upsampler_sparse
    bad = (["splat_segmented"] if cfg.splat_segmented else []) + (["sample_quad"] if quad else [])
    if cfg.audio_attn_impl in FORWARD_ONLY_ATTN_IMPLS:
        bad.append(f"audio_attn_impl={cfg.audio_attn_impl}")
    if bad:
        raise ValueError(
            f"training needs a differentiable path: {', '.join(bad)} selects a "
            "forward-only kernel (a serving option); S (splat_segmented), Q "
            f"(sample_quad; {QUAD_TRAINING_ITEM}) and the attention kernels "
            f"{', '.join(FORWARD_ONLY_ATTN_IMPLS)} have no backward. Train "
            "with the tile splat, the dense upsampler or the sparse one with "
            "the 4-tap or slab sampler, and audio_attn_impl flash")
