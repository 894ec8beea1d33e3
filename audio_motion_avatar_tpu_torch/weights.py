"""Weights: flax parameter tree -> PyTorch state_dict, and seeded init.

`params_from_flax` takes the JAX package's parameter tree as nested dicts of
numpy arrays (convert a flax tree with jax.tree_util.tree_map(np.asarray,
...)) of an AudioDrivenAvatar or a TriplaneGaussianAvatar and returns the
state_dict of the port's model of the same name. The port's modules carry
the flax names, so a leaf's key is its flax path; the one exception is the
point refiner, which the JAX package passes in from outside (its params sit
at the tree's top level) and the port keeps inside the renderer. Every leaf
is mapped; a subtree or leaf the port does not know raises.

Layout changes: Dense (in, out) -> Linear (out, in); conv HWIO -> OIHW;
attention kernels (C, H, D) / (H, D, C) -> Linear over H*D; biases (H, D)
-> (H*D,); the serial CPE (3, 1, C) -> depthwise (C, 1, 3); time_kernel
(3, C, T) -> the reference Conv3d weight (3C, 1, T, 1, 1); LayerNorm /
GroupNorm / affine `scale` and Embed `embedding` -> `weight`; raw params
(pos_embed, smpl_tokens, the tokenizer's embeddings) keep name and layout;
a sparse conv's `subm_kernel` (C_out, k, k, k, C_in) -> `weight` as it is;
a BatchNorm's `mean` / `var` -> `running_mean` / `running_var`.

Every rule is a relayout, so a gradient tree (jax.grad of a loss of the
params: a cotangent has the params' layout) maps the same way:
params_from_flax of it gives the gradients keyed and laid out as the port's
parameters' .grad, leaf by leaf.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

# top-level subtrees of an AudioDrivenAvatar / a TriplaneGaussianAvatar tree
STAGE2_ROOTS = ("triplane_gaussian", "audio_triplane", "point_refiner")
STAGE1_ROOTS = ("sapiens_encoder", "image_feature", "smplx_triplane_encoder",
                "fusion_network", "renderer", "point_refiner")
# params declared with self.param in flax (no Dense / Conv / Embed around them)
RAW_PARAMS = ("pos_embed", "smpl_tokens", "embeddings")


def _leaves(tree, path=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _convert_leaf(path: tuple, a: np.ndarray) -> Tuple[str, np.ndarray]:
    """(module path, leaf name) -> (torch leaf name, array in torch layout)."""
    leaf, parent = path[-1], path[-2] if len(path) > 1 else ""
    if leaf == "kernel":
        if a.ndim == 2:
            return "weight", a.T
        if a.ndim == 3 and parent in ("query", "key", "value"):
            return "weight", a.reshape(a.shape[0], -1).T
        if a.ndim == 3 and parent == "out":
            return "weight", a.reshape(-1, a.shape[-1]).T
        if a.ndim == 3 and parent == "cpe":
            return "weight", a.transpose(2, 1, 0)
        if a.ndim == 4:
            return "weight", a.transpose(3, 2, 0, 1)
    elif leaf == "conv_kernel" and a.ndim == 4:
        return "conv_weight", a.transpose(3, 2, 0, 1)
    elif leaf in ("bias", "conv_bias"):
        return leaf, a.reshape(-1)
    elif leaf == "scale" and a.ndim == 1:
        return "weight", a
    elif leaf == "embedding" and a.ndim == 2:
        return "weight", a
    elif leaf in RAW_PARAMS:
        return leaf, a
    elif leaf == "subm_kernel" and a.ndim == 5:
        return "weight", a
    elif leaf in ("mean", "var") and a.ndim == 1:
        return f"running_{leaf}", a
    elif leaf == "time_kernel" and a.ndim == 3:
        P, C, T = a.shape
        return "weight", a.reshape(P * C, 1, T, 1, 1)
    raise KeyError(f"params_from_flax: no rule for {'/'.join(path)} {a.shape}")


def _module_path(parts: tuple) -> str:
    # nn.Sequential children: flax layers_<i> -> torch <i>
    return ".".join(p[len("layers_"):] if p.startswith("layers_") else p
                    for p in parts)


def _entry(prefix: str, path: tuple, a: np.ndarray) -> Tuple[str, torch.Tensor]:
    """One flax leaf at `path` (relative to the module at `prefix`) -> its
    state_dict key and fp32 tensor."""
    name, arr = _convert_leaf(path, a)
    key = ".".join(filter(None, (prefix, _module_path(path[:-1]), name)))
    return key, torch.from_numpy(np.ascontiguousarray(arr, np.float32))


def convert_subtree(tree: dict) -> Dict[str, torch.Tensor]:
    """One module's flax params -> the state_dict of its torch counterpart
    (same leaf rules as params_from_flax, keys relative to the module)."""
    return dict(_entry("", path, a) for path, a in _leaves(tree))


def flax_entries(tree: dict) -> Iterator[Tuple[tuple, str, torch.Tensor]]:
    """(flax path, state_dict key, fp32 tensor) for every leaf of a flax
    param tree, as params_from_flax maps it."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    stage2 = "triplane_gaussian" in tree or "audio_triplane" in tree
    roots = STAGE2_ROOTS if stage2 else STAGE1_ROOTS
    refiner = ("triplane_gaussian.renderer.point_refiner" if stage2
               else "renderer.point_refiner")
    for path, a in _leaves(tree):
        if path[0] not in roots:
            raise KeyError(f"params_from_flax: unknown subtree {'/'.join(path)}")
        if path[0] == "point_refiner":
            yield (path,) + _entry(refiner, path[1:], a)
        else:
            yield (path,) + _entry("", path, a)


def params_from_flax(tree: dict) -> Dict[str, torch.Tensor]:
    """flax param tree (nested dicts of numpy arrays, with or without the
    top-level "params" key) of an AudioDrivenAvatar or a
    TriplaneGaussianAvatar -> the port's state_dict of the same model (fp32).
    A tree that holds only some subtrees (e.g. a serving rollout's) maps to
    the matching part of the model."""
    return {key: val for _, key, val in flax_entries(tree)}


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> None:
    """Seeded init (drawn on the CPU, so every device gets the same values):
    weights ~ N(0, 1 / fan_in), biases 0, norm scales 1; the renderer's
    heads then take the reference init (renderer.reset_heads)."""
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("bias"):
            p.zero_()
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            fan_in = p[0].numel()
            w = torch.randn(p.shape, generator=g) / math.sqrt(fan_in)
            p.copy_(w.to(p.device))
    for m in model.modules():
        if hasattr(m, "reset_heads"):
            m.reset_heads()


@torch.no_grad()
def perturb_heads(model: nn.Module, seed: int = 1, std: float = 1e-2) -> None:
    """Add N(0, std) noise to the five gaussian head kernels (zero at init,
    which would make every gaussian identical)."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if hasattr(m, "reset_heads"):
            for layer in m._heads():
                noise = torch.randn(layer.weight.shape, generator=g) * std
                layer.weight.add_(noise.to(layer.weight.device))
