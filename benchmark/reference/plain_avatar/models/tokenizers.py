"""Triplane tokenizer: a learnable (3, C, P, P) positional grid added to the
conditioning planes and flattened to channel-first tokens."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.triplane import planes_to_tokens


class TriplanePositionalEmbedding(nn.Module):
    def __init__(self, num_channels: int = 1024, plane_size: int = 32):
        super().__init__()
        self.embeddings = nn.Parameter(
            torch.zeros(3, num_channels, plane_size, plane_size))

    def forward(self, batch_size: int, cond_planes: torch.Tensor) -> torch.Tensor:
        """cond_planes (B, 3, C, P, P) -> (B, C, 3 P P) tokens."""
        planes = self.embeddings[None].expand((batch_size,) + self.embeddings.shape)
        return planes_to_tokens(planes + cond_planes)
