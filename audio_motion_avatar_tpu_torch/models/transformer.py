"""Transformer stack: pre-LN blocks with self-attention, optional
cross-attention and a GEGLU feed-forward; channel-first (B, C, S) in/out
with a GroupNorm + projection residual wrapper (Transformer1D).

Dtype semantics follow the JAX package: parameters stay fp32; with a
compute dtype (bf16) every projection casts its input and weights to it;
LayerNorm / GroupNorm statistics are taken in fp32. Norm epsilons are
flax's 1e-6 (torch defaults to 1e-5). Self-attention with head width 64
runs through kernel A (ops/attention.py), in bf16 on the card, and under
autograd through its Function (kernel A-bwd for the gradients).

The JAX package names its self-attention kernels (`attn_impl`): the stock
flash kernel, its base-2 clone flash2, the stock splash kernel (FullMask,
padding by segment ids, q pre-scaled) and its own serve / hpack kernels.
Each computes softmax((q scale) k^T) v over the valid keys, kernel A's
function, so every name runs kernel A here; only 'flash' has a backward.

Tensor parallelism (parallel/mesh.shard_model): Attention splits its heads
over the 'model' axis (q / k / v column-parallel, out row-parallel) and
GEGLUFeedForward its hidden width (wi column-parallel, each rank holding
the matching columns of both the h and the gate halves; wo row-parallel),
the layers the JAX package annotates ('heads', 'mlp').
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import KERNEL_HEAD_DIM, attention_autograd, dense_attention
from ..parallel.tensor import ModelAxis, copy_to_model, reduce_from_model

ATTN_IMPLS = ("flash", "flash2", "splash", "serve", "hpack")
FORWARD_ONLY_ATTN_IMPLS = ("flash2", "splash", "serve", "hpack")


def check_attn_impl(name: str) -> str:
    """An attention implementation name of the JAX package, or raise."""
    if name not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {name!r} (one of {ATTN_IMPLS})")
    return name


def linear(x: torch.Tensor, layer: nn.Linear,
           dtype: Optional[torch.dtype]) -> torch.Tensor:
    """nn.Linear in the compute dtype (flax Dense(dtype=...) semantics)."""
    if dtype is None:
        return layer(x)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def row_linear(x: torch.Tensor, layer: nn.Linear, dtype: Optional[torch.dtype],
               tp: Optional[ModelAxis]) -> torch.Tensor:
    """`linear` of a row-parallel layer: this rank's columns contracted in
    float32 on operands rounded to the compute dtype (the partial sums are
    not rounded before the reduce: the whole product rounds once, as it does
    in one process), reduced over 'model', the bias added once."""
    if tp is None:
        return linear(x, layer, dtype)
    w = layer.weight if dtype is None else layer.weight.to(dtype)
    y = reduce_from_model(F.linear(x.to(w.dtype).float(), w.float()), tp)
    if layer.bias is not None:
        y = y + layer.bias
    return y.to(x.dtype if dtype is None else dtype)


class LayerNorm(nn.LayerNorm):
    """flax LayerNorm: eps 1e-6, statistics in fp32, output in the compute
    dtype (fp32 when none is set)."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__(dim, eps=1e-6)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y if self.compute_dtype is None else y.to(self.compute_dtype)


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, T, H*D) -> (B, H, T, D) contiguous."""
    B, T, inner = x.shape
    return x.reshape(B, T, heads, inner // heads).transpose(1, 2).contiguous()


def merge_heads(y: torch.Tensor) -> torch.Tensor:
    """(B, H, T, D) -> (B, T, H*D)."""
    B, H, T, D = y.shape
    return y.transpose(1, 2).reshape(B, T, H * D)


def head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float,
                   kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, S, D) attention: kernel A where D is its width (with kernel
    A-bwd where a gradient flows), the dense chain in the operands' dtype
    otherwise. Kernel A takes bf16 operands and raises on others: on the
    card a D = 64 head needs the bf16 compute dtype, and no fp32
    configuration is quietly run in bf16."""
    if q.shape[-1] != KERNEL_HEAD_DIM:
        return dense_attention(q, k, v, scale, kv_mask)
    return attention_autograd(q, k, v, scale, kv_mask)


class Attention(nn.Module):
    """Multi-head attention (no qkv bias, biased output projection,
    scale head_dim**-0.5), optionally cross (kv from `context`).
    q_tail: compute only the last q_tail query positions. Sharded over
    'model' (tp), it holds heads / n heads."""

    tp: Optional[ModelAxis] = None

    def __init__(self, query_dim: int, heads: int, head_dim: int, out_dim: int,
                 context_dim: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None,
                 q_tail: Optional[int] = None):
        super().__init__()
        inner = heads * head_dim
        kv_dim = query_dim if context_dim is None else context_dim
        self.heads, self.head_dim = heads, head_dim
        self.dtype, self.q_tail = dtype, q_tail
        self.q = nn.Linear(query_dim, inner, bias=False)
        self.k = nn.Linear(kv_dim, inner, bias=False)
        self.v = nn.Linear(kv_dim, inner, bias=False)
        self.out = nn.Linear(inner, out_dim)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        tp = self.tp
        x = copy_to_model(x, tp)
        kv_src = x if context is None else copy_to_model(context, tp)
        if kv_src.shape[1] == 1:
            # EXACT single-key shortcut: softmax over one key is 1, so every
            # query's output is that key's projected value
            q_len = x.shape[1] if self.q_tail is None else self.q_tail
            out1 = row_linear(linear(kv_src, self.v, self.dtype), self.out, self.dtype, tp)
            return out1.expand(x.shape[0], q_len, out1.shape[-1])
        heads = self.q.weight.shape[0] // self.head_dim          # this rank's
        xq = x if self.q_tail is None else x[:, -self.q_tail:]
        q = split_heads(linear(xq, self.q, self.dtype), heads)
        k = split_heads(linear(kv_src, self.k, self.dtype), heads)
        v = split_heads(linear(kv_src, self.v, self.dtype), heads)
        out = head_attention(q, k, v, self.head_dim ** -0.5)
        return row_linear(merge_heads(out), self.out, self.dtype, tp)


class GEGLUFeedForward(nn.Module):
    """proj to 2 * mult * dim, split, x * gelu(gate), project back. Sharded
    over 'model' (tp), wi holds this rank's columns of h, then the same
    columns of gate, and wo the matching rows."""

    tp: Optional[ModelAxis] = None

    def __init__(self, dim: int, mult: int = 4,
                 dtype: Optional[torch.dtype] = None, gelu_approx: bool = False):
        super().__init__()
        self.wi = nn.Linear(dim, dim * mult * 2)
        self.wo = nn.Linear(dim * mult, dim)
        self.dtype = dtype
        self.approximate = "tanh" if gelu_approx else "none"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = linear(copy_to_model(x, self.tp), self.wi, self.dtype).chunk(2, dim=-1)
        h = h * F.gelu(gate, approximate=self.approximate)
        return row_linear(h, self.wo, self.dtype, self.tp)


class TransformerBlock(nn.Module):
    """Pre-LN block: self-attn -> (cross-attn) -> GEGLU FF, residuals."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None,
                 q_tail: Optional[int] = None, gelu_approx: bool = False):
        super().__init__()
        self.q_tail = q_tail
        self.norm1 = LayerNorm(dim, dtype)
        self.attn1 = Attention(dim, heads, head_dim, dim, dtype=dtype,
                               q_tail=q_tail)
        self.has_context = context_dim is not None
        if self.has_context:
            self.norm2 = LayerNorm(dim, dtype)
            self.attn2 = Attention(dim, heads, head_dim, dim,
                                   context_dim=context_dim, dtype=dtype)
        self.norm3 = LayerNorm(dim, dtype)
        self.ff = GEGLUFeedForward(dim, dtype=dtype, gelu_approx=gelu_approx)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.norm1(x)
        if self.q_tail is not None:
            x = x[:, -self.q_tail:]
        x = x + self.attn1(h)
        if self.has_context:
            x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer1D(nn.Module):
    """(B, C, S) tokens: GroupNorm(32) over C, project to heads*head_dim, N
    blocks, project back, residual add. final_tail: the output covers only
    the last final_tail positions (the last block computes just those).
    remat: under autograd each block is recomputed in the backward
    (torch.utils.checkpoint) instead of keeping its activations. attn_impl:
    the self-attention's name in the JAX package (every one is kernel A)."""

    def __init__(self, num_layers: int, heads: int, head_dim: int,
                 in_channels: int, context_dim: Optional[int] = None,
                 norm_num_groups: int = 32,
                 dtype: Optional[torch.dtype] = None,
                 final_tail: Optional[int] = None, gelu_approx: bool = False,
                 remat: bool = False, attn_impl: str = "flash"):
        super().__init__()
        inner = heads * head_dim
        self.dtype, self.final_tail, self.remat = dtype, final_tail, remat
        self.attn_impl = check_attn_impl(attn_impl)
        self.norm = nn.GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.num_layers = num_layers
        for i in range(num_layers):
            tail = final_tail if i == num_layers - 1 else None
            self.add_module(f"block_{i}", TransformerBlock(
                inner, heads, head_dim, context_dim=context_dim, dtype=dtype,
                q_tail=tail, gelu_approx=gelu_approx))
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, tokens: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        residual = tokens
        h = self.norm(tokens.float()).transpose(1, 2)             # (B, S, C)
        h = linear(h, self.proj_in, self.dtype)
        remat = self.remat and torch.is_grad_enabled()
        for i in range(self.num_layers):
            block = getattr(self, f"block_{i}")
            h = (checkpoint(block, h, context, use_reentrant=False) if remat
                 else block(h, context))
        h = linear(h, self.proj_out, self.dtype)
        if self.final_tail is not None:
            residual = residual[:, :, -self.final_tail:]
        return h.transpose(1, 2) + residual
