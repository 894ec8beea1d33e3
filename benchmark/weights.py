"""Seeded weights, drawn on the device in a few large calls.

Every matrix ~ N(0, 1 / fan_in), biases 0, 1-D scales 1 (the port's own
seeded init, drawn here from the benchmark's generator); the gaussian heads
then take the reference init, a perturbation and the configuration's
`heads` settings, so that frames are not blank:

- `tame` (serving): the decoded body kept upright near the origin and the
  token update damped, so the autoregressive steps keep the tokens O(0.1);
- `visible`: uniform, larger, more opaque gaussians on the body.

The weights go into the reference model built here and, as its
state_dict, into the port.
"""

from __future__ import annotations

import torch
from torch import nn

CHUNK = 1 << 27   # normal draws a call


@torch.no_grad()
def seed_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter of `model` in place from `generator`."""
    mats = []
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1].endswith("bias"):
            p.zero_()
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            mats.append(p)
    total = sum(p.numel() for p in mats)
    dev = mats[0].device
    buf, used = None, CHUNK
    for p in mats:
        flat, done, scale = p.view(-1), 0, p[0].numel() ** -0.5
        while done < flat.numel():
            if used == CHUNK:
                n = min(CHUNK, total)
                buf = torch.randn(n, generator=generator, device=dev)
                total -= n
                used = 0
            take = min(flat.numel() - done, buf.numel() - used)
            flat[done:done + take].copy_(buf[used:used + take]).mul_(scale)
            done += take
            used += take


@torch.no_grad()
def seed_heads(model: nn.Module, generator: torch.Generator, heads: dict) -> None:
    """The renderer's reference head init, N(0, perturb_std) on the head
    kernels (zero at init, which would make every gaussian alike), then the
    `tame` / `visible` settings of `heads`."""
    std = heads["perturb_std"]
    for m in model.modules():
        if hasattr(m, "reset_heads"):
            m.reset_heads()
            ws = [layer.weight for layer in m._heads()]
            noise = torch.randn(sum(w.numel() for w in ws), generator=generator,
                                device=ws[0].device) * std
            for w, n in zip(ws, noise.split([w.numel() for w in ws])):
                w.add_(n.view_as(w))
    if heads.get("tame"):
        tame(model)
    if "visible" in heads:
        visible(model.renderer, **heads["visible"])


@torch.no_grad()
def tame(model: nn.Module) -> None:
    """Keep the decoded body upright and near the origin (random root
    rotations and translations move it out of the orbiting cameras' view)
    and damp the token update, as trained weights keep the tokens O(0.1):
    undamped, each step adds an O(1) update and within a few requests the
    opacities collapse and the frames are blank."""
    dec = model.smpl_decoder
    model.audio_triplane.transformer.proj_out.weight.mul_(0.01)
    dec.transl.weight.mul_(0.01)
    dec.transl.bias.zero_()
    dec.body_root_pose.weight.mul_(0.01)
    dec.body_root_pose.bias.copy_(torch.tensor([1.0, 0, 0, 0, 1, 0]))


@torch.no_grad()
def visible(renderer: nn.Module, scale_bias: float, opacity_bias: float) -> None:
    """Uniform gaussians of the given scale and opacity logits on the body,
    coloured by the perturbed colour head."""
    renderer.scaling_layer.bias.fill_(scale_bias)
    renderer.opacity_layer.bias.fill_(opacity_bias)
    for layer in (renderer.xyz_layer, renderer.scaling_layer, renderer.opacity_layer):
        layer.weight.zero_()
