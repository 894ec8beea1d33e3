"""Tensor parallelism over the mesh's 'model' axis: the collectives of
Megatron's layers, written by hand as autograd functions.

A module sharded by parallel/mesh.shard_model carries `tp` (a ModelAxis);
modules left whole carry None and every helper here is then the identity.
The layers the JAX package annotates split as Megatron does:

- column-parallel (q / k / v, GEGLU's wi, the MLPs' first layer, the
  upsampler's conv_out convs): the input is replicated, `copy_to_model`
  passes it through and all-reduces its gradient; each rank computes its
  heads or hidden columns;
- row-parallel (the attention's out, GEGLU's wo, the MLPs' second layer,
  the ResBlock's conv2): each rank contracts its own columns in float32
  (on operands rounded to the compute dtype: rounding each partial sum to
  bf16 before the reduce moved the full-width serving frames beyond the
  rounding class), `reduce_from_model` all-reduces the partial sums and
  the replicated bias is added once after the sum;
- `gather_from_model` joins a channel-sharded activation where a
  replicated layer follows (UpsampleBlock's conv into its ResBlock);
- `local_part` is a replicated parameter's slice for this rank's channels,
  its gradient summed over 'model' so that every rank holds all of it.

Kernels always receive the local, plain tensors: kernel A runs on the local
heads (B, H / n, S, D).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This process's place on the 'model' axis."""
    group: object
    size: int
    rank: int


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group, in float32 (gloo sums no bfloat16)."""
    y = x.detach().to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=group)
    return y


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group).to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: ModelAxis, dim: int):
        ctx.axis, ctx.dim, n = axis, dim, x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * axis.size
        full = torch.zeros(shape, dtype=x.dtype, device=x.device)
        full.narrow(dim, axis.rank * n, n).copy_(x)
        dist.all_reduce(full, group=axis.group)       # exact: one term is not 0
        return full

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.axis.size
        return g.narrow(ctx.dim, ctx.axis.rank * n, n).contiguous(), None, None


def copy_to_model(x: torch.Tensor, tp: Optional[ModelAxis]) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over 'model'."""
    return x if tp is None else _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: Optional[ModelAxis]) -> torch.Tensor:
    """The partial sums all-reduced over 'model' (float32 out); identity
    backward."""
    return x if tp is None else _ReduceFromModel.apply(x, tp.group)


def gather_from_model(x: torch.Tensor, tp: Optional[ModelAxis],
                      dim: int = -1) -> torch.Tensor:
    """The ranks' slices joined along `dim` in rank order; the gradient's
    own slice backward."""
    return x if tp is None else _GatherFromModel.apply(x, tp, dim % x.dim())


def local_part(p: torch.Tensor, tp: Optional[ModelAxis], dim: int = 0) -> torch.Tensor:
    """A replicated tensor's slice of this rank's channels along `dim`."""
    if tp is None:
        return p
    n = p.shape[dim] // tp.size
    return copy_to_model(p, tp).narrow(dim, tp.rank * n, n)
