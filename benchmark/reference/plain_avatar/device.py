"""The precision settings of the reference's geometry and stacks."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch


@contextlib.contextmanager
def fp32_geometry():
    """TF32 off for fp32 matmuls and convolutions inside the block (or the
    decorated function), the caller's settings restored after. The
    geometry (SMPL-X FK/LBS, projection) uses it: at TF32 the 55-joint
    chain loses ~1e-3 of vertex accuracy."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def compute_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """AvatarConfig.compute_dtype string -> torch dtype (None = float32)."""
    if name in (None, "float32"):
        return None
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"unsupported compute_dtype {name!r}")
