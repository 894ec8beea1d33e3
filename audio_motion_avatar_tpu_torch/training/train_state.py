"""Optimizer and train state (the JAX package's training/train_state.py).

The JAX package's optax chain, step for step and in float32:

    MultiSteps(apply_if_finite(chain(clip_by_global_norm, adam(schedule))))

- clip_by_global_norm: g / ||g|| * max_norm where ||g|| >= max_norm, with no
  epsilon in the divisor (unlike torch.nn.utils.clip_grad_norm_);
- Adam: m = (1 - b1) g + b1 m, v = (1 - b2) g^2 + b2 v, the update
  m_hat / (sqrt(v_hat) + 1e-8) scaled by -lr(n) at the n-th applied update
  (n from 0; the bias correction powers by n + 1): Adam and the schedule
  count the same updates;
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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import torch
from torch import nn

from ..models.transformer import FORWARD_ONLY_ATTN_IMPLS


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


class Optimizer:
    """The chain above over a fixed, ordered set of named parameters."""

    def __init__(self, cfg: OptimConfig, params: Dict[str, torch.Tensor]):
        if cfg.weight_decay > 0:
            raise NotImplementedError("weight_decay > 0 (optax.adamw) is not ported")
        self.cfg = cfg
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
        if cfg.nan_guard:
            finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            if not finite and self.notfinite_count <= cfg.nan_guard_max_consecutive:
                return
        g_norm = global_norm(grads.values())
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
    (not frozen) parameters."""

    def __init__(self, model: nn.Module, optim: OptimConfig,
                 prefixes: Iterable[str] = FROZEN_PREFIXES):
        self.model = model
        self.step = 0
        self.trainable = {k: p for k, p in model.named_parameters()
                          if not is_frozen(k, prefixes)}
        self.frozen = {k: p for k, p in model.named_parameters()
                       if is_frozen(k, prefixes)}
        self.opt = Optimizer(optim, self.trainable)

    def grads(self) -> Dict[str, torch.Tensor]:
        """The trainable parameters' gradients (zeros where none flowed)."""
        return {k: torch.zeros_like(p) if p.grad is None else p.grad
                for k, p in self.trainable.items()}

    def zero_grad(self) -> None:
        for p in self.model.parameters():
            p.grad = None

    def apply_gradients(self, grads: Optional[Dict[str, torch.Tensor]] = None) -> bool:
        """Update the trainable parameters from `grads` (default: their
        .grad); returns whether an update was applied."""
        self.step += 1
        return self.opt.apply(self.grads() if grads is None else grads,
                              self.trainable)


def check_differentiable(cfg) -> None:
    """Refuse, when a training step is built, the options that select a
    forward-only kernel: the segmented splat (kernel S) and the sparse
    upsampler's quad sampling (kernel Q) have no backward, nor have the
    JAX package's forward-only attention kernels (audio_attn_impl flash2,
    splash, serve, hpack). The Winograd convs train (their backward is the
    direct conv's)."""
    bad = [name for name in ("splat_segmented", "upsampler_sparse", "sample_quad")
           if getattr(cfg, name)]
    if cfg.audio_attn_impl in FORWARD_ONLY_ATTN_IMPLS:
        bad.append(f"audio_attn_impl={cfg.audio_attn_impl}")
    if bad:
        raise ValueError(
            f"training needs a differentiable path: {', '.join(bad)} selects a "
            "forward-only kernel (a serving option); train with the default "
            "form (tile splat, dense upsampler, audio_attn_impl flash)")
