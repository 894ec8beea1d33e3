"""Exact attention in plain PyTorch, computed in blocks of query rows.

softmax(q k^T * scale + key_mask) v for (B, H, S, D) heads, in float32 (or
float64 for float64 inputs), one block of query rows at a time so that a
6304-token self-attention or the ViT's 4096 tokens fit beside the rest.
`dense_attention` is the dense chain in the operands' dtype, used where the
head width is not 64.
"""

from __future__ import annotations

from typing import Optional

import torch

from .calls import logged

MASKED = -1e30   # a masked key's logit (all-masked rows average uniformly)
KERNEL_HEAD_DIM = 64
QUERY_BLOCK = 1024


@logged("attention")
def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, H, Sq, D), k / v (B, H, Skv, D), kv_mask (B, Skv) bool ->
    (B, H, Sq, D) in q.dtype."""
    dt = torch.promote_types(q.dtype, torch.float32)
    kf, vf = k.to(dt), v.to(dt)
    out = []
    for s in range(0, q.shape[2], QUERY_BLOCK):
        logits = torch.einsum("bhsd,bhtd->bhst", q[:, :, s:s + QUERY_BLOCK].to(dt), kf) * scale
        if kv_mask is not None:
            logits = logits.masked_fill(~kv_mask[:, None, None, :], MASKED)
        out.append(torch.einsum("bhst,bhtd->bhsd", torch.softmax(logits, dim=-1), vf))
    return torch.cat(out, 2).to(q.dtype)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dense chain in the operands' dtype: softmax(q k^T * scale
    [masked]) v. Used where the head width is not 64."""
    logits = torch.einsum("bhsd,bhtd->bhst", q, k) * scale
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask[:, None, None, :],
                                    torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs, v)
