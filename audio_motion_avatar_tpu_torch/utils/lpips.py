"""LPIPS perceptual distance with the VGG16 backbone (lpips' net='vgg'
topology, the JAX package's utils/lpips.py): the five VGG16 stage features,
each unit-normalised over channels, squared differences through a per-stage
1x1 linear head, spatial means summed over the stages.

Module names follow the JAX package's flax tree (vgg/conv{stage}_{i},
lin{i}), so `weights.convert_subtree` maps its parameters leaf for leaf.
Without weights the features are seeded random ones and `pretrained` is
False (a smoke path only, said loudly); a given path is a torch state
dict of this module, read with weights_only=True. Nothing is downloaded.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# VGG16 conv plan: (channels, convs) a stage; LPIPS taps the relu ending each
VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    def __init__(self):
        super().__init__()
        cin = 3
        for si, (ch, n) in enumerate(VGG_STAGES):
            for ci in range(n):
                self.add_module(f"conv{si}_{ci}", nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch
        self.register_buffer("shift", torch.tensor(SHIFT).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE).reshape(1, 3, 1, 1), persistent=False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, H, W, 3) in [-1, 1] -> the five stage features (B, C, h, w)."""
        h = (x.permute(0, 3, 1, 2) - self.shift) / self.scale
        feats = []
        for si, (_, n) in enumerate(VGG_STAGES):
            for ci in range(n):
                h = torch.relu(getattr(self, f"conv{si}_{ci}")(h))
            feats.append(h)
            if si < len(VGG_STAGES) - 1:
                h = F.max_pool2d(h, 2, 2)
        return feats


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, (ch, _) in enumerate(VGG_STAGES):
            self.add_module(f"lin{i}", nn.Conv2d(ch, 1, 1, bias=False))

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """img0 / img1 (B, H, W, 3) in [-1, 1] -> (B,) distances."""
        total = 0.0
        for i, (a, b) in enumerate(zip(self.vgg(img0), self.vgg(img1))):
            a = a / torch.clamp(torch.linalg.norm(a, dim=1, keepdim=True), min=1e-10)
            b = b / torch.clamp(torch.linalg.norm(b, dim=1, keepdim=True), min=1e-10)
            total = total + getattr(self, f"lin{i}")((a - b) ** 2).mean(dim=(1, 2, 3))
        return total


@torch.no_grad()
def seeded_init(model: LPIPS, seed: int = 0) -> None:
    """Random features from a seed (N(0, 1 / fan_in) kernels, zero biases)
    and the linear heads at 1 / C, so that the distance is a plain feature
    distance, as the JAX class's unpretrained init."""
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.startswith("lin"):
            p.fill_(1.0 / p.shape[1])
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(p[0].numel()))


class LPIPSLoss:
    """The reference's interface: images (B, H, W, 3) in [0, 1] (tensors or
    numpy), an optional bbox crop [(x0, y0, w, h)] -> the mean distance.
    Runs on the images' device."""

    def __init__(self, weights_path: Optional[str] = None):
        self.module = LPIPS().eval()
        self.pretrained = False
        if weights_path and os.path.exists(weights_path):
            self.module.load_state_dict(torch.load(weights_path, map_location="cpu",
                                                   weights_only=True), strict=True)
            self.pretrained = True
        else:
            seeded_init(self.module)
            print("[lpips] no pretrained VGG / lpips weights given -> UNPRETRAINED "
                  "features (smoke use only)")

    def __call__(self, img_out, img_target, bbox=None) -> torch.Tensor:
        x, y = (torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
                for v in (img_out, img_target))
        if bbox is not None:
            x0, y0, w, h = [int(v) for v in bbox[0]]
            x, y = x[:, y0:y0 + h, x0:x0 + w], y[:, y0:y0 + h, x0:x0 + w]
        self.module.to(x.device)
        with torch.no_grad():
            return self.module(x.float() * 2 - 1, y.float() * 2 - 1).mean()
