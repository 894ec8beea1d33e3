"""Exact attention forward (kernel A) and the dense reference chain.

`attention` computes softmax(q k^T * scale + key_mask) v for (B, H, S, D)
heads with D = 64 — the audio self-attention and the PTv3 decoder's
patch attention. On CUDA tensors it launches kernel A (bf16 operands, fp32
softmax and accumulation); on CPU tensors it runs `attention_plain`.

Training differentiates it through `AttentionFunction`: kernel A forward,
which then also writes each row's softmax statistics (m, l), and kernel
A-bwd (csrc/attention_bwd.cu, `attention_bwd`) for dQ / dK / dV; on CPU
tensors the same Function runs `attention_plain` and `attention_bwd_plain`.

`dense_attention` is the JAX package's dense chain (logits, softmax in the
compute dtype, P V), which it uses for the head widths its Pallas kernels
do not take (D = 16 / 32 in the refiner and the SMPL-X reducer); the port
keeps those in plain PyTorch too.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels

MASKED = -1e30   # a masked key's logit (all-masked rows average uniformly)
KERNEL_HEAD_DIM = 64


def excess_error(out: torch.Tensor, ref: torch.Tensor) -> float:
    """How far a bf16 output `out` of kernel A is from its fp32 reference
    `ref` (the plain version on the same inputs, in fp32), as the worst
    ratio of |out - ref| to its tolerance: one bf16 spacing of the value
    (2^-7 |ref|; rounding the output costs at most half of it) plus 2^-4 of
    ref's RMS (the probabilities are rounded to bf16 for the P V product,
    which moves an output by ~2^-9 of the RMS). 1 or less agrees."""
    ref = ref.float()
    diff = (out.float() - ref).abs()
    rms = float(ref.pow(2).mean().sqrt())
    tol = 2.0 ** -7 * ref.abs() + 2.0 ** -4 * rms + torch.finfo(torch.float32).tiny
    return float((diff / tol).max())


def _plain_dtype(q: torch.Tensor) -> torch.dtype:
    """The plain versions compute in float32, or float64 for float64 inputs."""
    return torch.promote_types(q.dtype, torch.float32)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of kernel A, computed in float32, returned in q.dtype.
    q (B, H, Sq, D), k / v (B, H, Skv, D), kv_mask (B, Skv) bool."""
    dt = _plain_dtype(q)
    logits = torch.einsum("bhsd,bhtd->bhst", q.to(dt), k.to(dt)) * scale
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask[:, None, None, :], MASKED)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs, v.to(dt)).to(q.dtype)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, kv_mask: Optional[torch.Tensor],
                        dout: torch.Tensor):
    """Plain version of kernel A-bwd, in float32: the gradients (dq, dk, dv)
    of attention_plain's output against dout, in the inputs' dtypes. A
    masked logit is replaced by a constant, so it passes no gradient."""
    dt = _plain_dtype(q)
    qf, kf, vf, gf = (t.to(dt) for t in (q, k, v, dout))
    logits = torch.einsum("bhsd,bhtd->bhst", qf, kf) * scale
    keep = None if kv_mask is None else kv_mask[:, None, None, :]
    if keep is not None:
        logits = logits.masked_fill(~keep, MASKED)
    p = torch.softmax(logits, dim=-1)
    dv = torch.einsum("bhst,bhsd->bhtd", p, gf)
    dp = torch.einsum("bhsd,bhtd->bhst", gf, vf)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    if keep is not None:
        ds = ds.masked_fill(~keep, 0.0)
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kf) * scale
    dk = torch.einsum("bhst,bhsd->bhtd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_args(name, q, k, v, kv_mask):
    """Kernel A's and A-bwd's operand rules: bf16, D = 64, contiguous
    (B, H, S, D); kv_mask contiguous bool (B, Skv). Returns the mask
    pointer (None without a mask)."""
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"{name} kernel takes D={KERNEL_HEAD_DIM}, got {D}")
    for arg, t, s in (("q", q, Sq), ("k", k, Skv), ("v", v, Skv)):
        if t.dtype != torch.bfloat16 or t.shape != (B, H, s, D) or \
                not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name}: {arg} must be contiguous bf16 "
                             f"({B}, {H}, {s}, {D}) on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if kv_mask is None:
        return None
    if kv_mask.dtype != torch.bool or kv_mask.shape != (B, Skv) or \
            not kv_mask.is_contiguous() or kv_mask.device != q.device:
        raise ValueError(f"{name}: kv_mask must be contiguous bool "
                         f"({B}, {Skv}) on {q.device}")
    return kv_mask.data_ptr()


def _attention_kernel(q, k, v, scale, kv_mask, with_stats: bool):
    """One launch of kernel A -> (out, stats (B, H, Sq, 2) fp32 or None)."""
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    mask_ptr = _check_kernel_args("attention", q, k, v, kv_mask)
    B, H, Sq, _ = q.shape
    out = torch.empty_like(q)
    stats = (torch.empty(B, H, Sq, 2, dtype=torch.float32, device=q.device)
             if with_stats else None)
    lib = kernels.library("attention")
    rc = lib.attention_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              mask_ptr, out.data_ptr(),
                              None if stats is None else stats.data_ptr(),
                              B, H, Sq, k.shape[2], float(scale),
                              kernels.stream_ptr(q.device))
    kernels.check(rc, "attention")
    attention.launches += 1
    return out, stats


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel A on CUDA tensors (bf16, D = 64, contiguous (B, H, S, D)), its
    plain version on CPU tensors."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale, kv_mask)
    return _attention_kernel(q, k, v, scale, kv_mask, False)[0]


attention.launches = 0


BWD_BLOCK = 128   # keys (dK / dV blocks) or queries (dQ blocks) a block of A-bwd


def attention_bwd_scratch(B: int, H: int, Sq: int):
    """Shape of A-bwd's fp32 scratch: per query row {m, 1/l, Delta, 0}, (B H,
    Sq_pad, 4), Sq rounded up to the kernel's 128-query blocks
    (csrc/attention_bwd.cu reads whole 64-row tiles of it; the padding rows
    add nothing)."""
    return B * H, -(-Sq // BWD_BLOCK) * BWD_BLOCK, 4


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, kv_mask: Optional[torch.Tensor],
                  out: torch.Tensor, stats: torch.Tensor, dout: torch.Tensor):
    """Kernel A-bwd: (dq, dk, dv) bf16 of kernel A's attention, from the
    forward's output `out` and statistics `stats` and the output gradient
    `dout` (all contiguous, bf16 but stats fp32). CUDA tensors only: on the
    CPU, AttentionFunction runs attention_bwd_plain."""
    if q.device.type != "cuda":
        raise ValueError(f"attention_bwd: unsupported device {q.device}")
    mask_ptr = _check_kernel_args("attention_bwd", q, k, v, kv_mask)
    B, H, Sq, D = q.shape
    for arg, t in (("out", out), ("dout", dout)):
        if t.dtype != torch.bfloat16 or t.shape != q.shape or not t.is_contiguous():
            raise ValueError(f"attention_bwd: {arg} must be contiguous bf16 "
                             f"{tuple(q.shape)}, got {tuple(t.shape)} {t.dtype}")
    if stats.dtype != torch.float32 or stats.shape != (B, H, Sq, 2) or \
            not stats.is_contiguous():
        raise ValueError("attention_bwd: stats must be contiguous float32 "
                         f"({B}, {H}, {Sq}, 2)")
    rows = torch.empty(attention_bwd_scratch(B, H, Sq), dtype=torch.float32,
                       device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = kernels.library("attention_bwd")
    rc = lib.attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
        dout.data_ptr(), stats.data_ptr(), rows.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, H, Sq, k.shape[2], float(scale),
        kernels.stream_ptr(q.device))
    kernels.check(rc, "attention_bwd")
    attention_bwd.launches += 1
    return dq, dk, dv


attention_bwd.launches = 0


class AttentionFunction(torch.autograd.Function):
    """Attention under autograd: kernel A forward (with its statistics) and
    kernel A-bwd on CUDA tensors; attention_plain and attention_bwd_plain
    on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, scale, kv_mask):
        ctx.scale = scale
        if q.device.type == "cpu":
            out = attention_plain(q, k, v, scale, kv_mask)
            ctx.save_for_backward(q, k, v, kv_mask)
        else:
            out, stats = _attention_kernel(q, k, v, scale, kv_mask, True)
            ctx.save_for_backward(q, k, v, kv_mask, out, stats)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, *fwd = ctx.saved_tensors
        dout = dout.contiguous()
        if q.device.type == "cpu":
            grads = attention_bwd_plain(q, k, v, ctx.scale, kv_mask, dout)
        else:
            grads = attention_bwd(q, k, v, ctx.scale, kv_mask, *fwd, dout)
        return (*grads, None, None)


def attention_autograd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float,
                       kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`attention`, through AttentionFunction where a gradient will flow."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return AttentionFunction.apply(q, k, v, scale, kv_mask)
    return attention(q, k, v, scale, kv_mask)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float,
                    kv_mask: Optional[torch.Tensor] = None,
                    softmax_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The dense chain in the operands' dtype: softmax(q k^T * scale
    [masked]) v. Used where the head width is not the kernel's.
    softmax_dtype: q k^T and the softmax in that dtype instead, the
    probabilities rounded to v's dtype for P V."""
    if softmax_dtype is not None:
        q, k = q.to(softmax_dtype), k.to(softmax_dtype)
    logits = torch.einsum("bhsd,bhtd->bhst", q, k) * scale
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask[:, None, None, :],
                                    torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bhtd->bhsd", probs, v)
