"""Checkpoints in torch files, without the frozen encoder (the JAX
package's training/checkpoints.py, whose orbax directories this replaces).

`CheckpointManager(directory)` keeps one directory a step:
`<directory>/<step>/state.pt` holds the trainable parameters (the model's
state_dict without FROZEN_PREFIXES, the Sapiens ViT), the optimizer state
and the step; `metrics.json` the metrics the step was saved with. Retention
follows Lightning's ModelCheckpoint: with `monitor` set, the `max_to_keep`
best steps by the monitored metric (`mode` 'min' / 'max') plus always the
latest; saves without metrics keep the latest `max_to_keep` (FIFO).
`restore(state)` loads the latest (or a given) step into a TrainState,
the frozen parameters kept as the state has them.

Over a mesh the file holds the full tree: `save` gathers the
'model'-sharded parameters and their optimizer state (a collective: every
rank calls it) and rank 0 writes; `restore` reads the full tree on every
rank and keeps its own slices. A checkpoint of a data- or tensor-parallel
run restores in one process, and the reverse.

`load_torch_state_dict` and `import_torch_ckpt` are the numpy helpers of a
reference checkpoint's prefix remap.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from ..parallel.distributed import is_main
from .train_state import FROZEN_PREFIXES, TrainState, is_frozen

STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"


def split_frozen(params: Dict[str, torch.Tensor], prefixes=FROZEN_PREFIXES):
    """(trainable, frozen) partitions of a state_dict by dotted name."""
    train = {k: v for k, v in params.items() if not is_frozen(k, prefixes)}
    frozen = {k: v for k, v in params.items() if is_frozen(k, prefixes)}
    return train, frozen


def merge_frozen(train: dict, frozen: dict) -> dict:
    out = dict(train)
    out.update(frozen)
    return out


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


class CheckpointManager:
    """Saves {trainable params, optimizer state, step} a step; see the
    module docstring for the retention rule."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 monitor: Optional[str] = None, mode: str = "min"):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.monitor = monitor.split("/")[-1] if monitor else None
        self.mode = mode
        self._metric_history: dict = {}  # step -> monitored value (or None)

    def all_steps(self):
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, metrics: Optional[dict] = None):
        params, _ = split_frozen(state.model.state_dict())
        opt = dict(state.opt.state_dict())
        for name in ("mu", "nu", "acc"):
            opt[name] = state.gather(opt[name])
        payload = {"params": _cpu(state.gather(params)), "opt_state": _cpu(opt),
                   "step": int(state.step)}
        if not is_main():
            return
        final = os.path.join(self.directory, str(int(step)))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, METRICS_FILE), "w") as f:
            json.dump({k: float(v) for k, v in (metrics or {}).items()}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        cur = None
        if self.monitor and metrics and self.monitor in metrics:
            cur = float(metrics[self.monitor])
        self._metric_history[step] = cur
        self._evict()

    def _evict(self):
        steps = self.all_steps()
        if len(steps) <= self.max_to_keep:
            return
        latest = steps[-1]
        scored = [(s, self._metric_history.get(s)) for s in steps]
        with_metric = [(s, v) for s, v in scored if v is not None]
        if with_metric and self.monitor:
            sign = 1.0 if self.mode == "min" else -1.0
            ranked = sorted(with_metric, key=lambda sv: sign * sv[1])
            keep = {s for s, _ in ranked[: self.max_to_keep]}
        else:  # FIFO when no metric was ever supplied
            keep = set(steps[-self.max_to_keep:])
        keep.add(latest)  # save_last=True
        for s in steps:
            if s not in keep:
                shutil.rmtree(os.path.join(self.directory, str(s)))
                self._metric_history.pop(s, None)

    @torch.no_grad()
    def restore(self, state: TrainState, step: Optional[int] = None):
        """Load a step (default the latest) into `state` in place: the
        trainable parameters (every one, by name), the optimizer state and
        the step; the frozen parameters stay. -> (state, found)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return state, False
        payload = torch.load(os.path.join(self.directory, str(int(step)), STATE_FILE),
                             map_location="cpu", weights_only=True)
        want, _ = split_frozen(state.model.state_dict(keep_vars=True))
        got = state.shard(payload["params"])
        if set(got) != set(want):
            missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
            raise KeyError(f"checkpoint step {step} does not match the model: missing "
                           f"{missing[:8]}, unexpected {extra[:8]}")
        for k, v in got.items():
            if tuple(v.shape) != tuple(want[k].shape):
                raise ValueError(f"checkpoint {k}: shape {tuple(v.shape)} != "
                                 f"{tuple(want[k].shape)}")
            want[k].copy_(v)
        opt = dict(payload["opt_state"])
        for name in ("mu", "nu", "acc"):
            opt[name] = state.shard(opt[name])
        state.opt.load_state_dict(opt)
        state.step = int(payload["step"])
        return state, True


# ---------------------------------------------------------------------------
# reference checkpoint helpers (numpy)
# ---------------------------------------------------------------------------

def load_torch_state_dict(path: str) -> dict:
    """A Lightning .ckpt / torch .pt state dict as numpy arrays (read with
    weights_only=True: tensors and plain containers only; the JAX package
    reads with weights_only=False, so a file that pickles other objects
    loads there and raises here, saying what it could not read; a file
    that cannot be opened raises its OSError)."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except OSError:
        raise
    except Exception as e:
        lines = [ln.strip() for ln in str(e).splitlines() if ln.strip()]
        said = [ln for ln in lines if "Unsupported" in ln] or lines[:1]
        raise ValueError(f"{path!r} is not a torch checkpoint that torch.load reads with "
                         f"weights_only=True (tensors and plain containers): "
                         f"{type(e).__name__}: {' '.join(said)}") from e
    if not isinstance(ckpt, dict):
        raise ValueError(f"{path!r} holds a {type(ckpt).__name__}, not a state dict")
    sd = ckpt.get("state_dict", ckpt)
    return {k: v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in sd.items()}


def import_torch_ckpt(state_dict: dict, strip_prefixes=("triplane_gaussian.",),
                      drop_substrings=("sapiens_encoder", "image_feature")) -> dict:
    """Prefix remap and filter of the reference's weight surgery: drop the
    keys holding any of `drop_substrings`, strip the first matching prefix.
    Returns a flat {remapped name: array} dict."""
    out = {}
    for k, v in state_dict.items():
        if any(s in k for s in drop_substrings):
            continue
        for p in strip_prefixes:
            if k.startswith(p):
                k = k[len(p):]
                break
        out[k] = v
    return out
