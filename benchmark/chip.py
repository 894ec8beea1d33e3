"""The card: what a run needs of it, what it reads of it, and its peaks.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity),
valid at its full 700 W power limit: `card_info` reads the limit the card
is set to, so a number can be read beside it.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Dict, Optional

PEAK_BF16_FLOPS = 989e12     # tensor cores, bf16 / fp16
PEAK_BYTES = 3.35e12         # HBM3

# top-level module names the timed process may not hold (whole names: the
# port's own name begins with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "audio_motion_avatar_tpu")


class NoCard(RuntimeError):
    """The cell cannot run here: no CUDA card, or fewer than it asks for."""


def require_cards(count: int) -> None:
    """Raise NoCard unless `count` CUDA cards are visible."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: this benchmark "
                     "measures the port on a CUDA card")
    have = torch.cuda.device_count()
    if have < count:
        raise NoCard(f"the cell asks for {count} cards, {have} visible")


def forbidden_loaded(modules=None) -> list:
    """Top-level names of FORBIDDEN_MODULES present in `modules` (default
    sys.modules), compared as whole names."""
    names = {name.split(".", 1)[0] for name in (sys.modules if modules is None else modules)}
    return sorted(n for n in FORBIDDEN_MODULES if n in names)


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the card could take for `flops` operations and
    `nbytes` bytes moved: the larger of the two times, in ms."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES) * 1e3


def card_info(index: int = 0) -> Dict[str, Optional[str]]:
    """Name, power limit, SM clock and temperature as nvidia-smi reads them
    (None where it cannot be run)."""
    fields = ("name", "power.limit", "clocks.sm", "temperature.gpu")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", f"--query-gpu={','.join(fields)}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return {f: None for f in fields}
    parts = [p.strip() for p in out.split(",")]
    return dict(zip(fields, parts + [None] * (len(fields) - len(parts))))
