"""Closed-loop stage-2 serving with the point refiner in its published form,
Pointcept's PT-v3m1: `drivers/serve.py`'s traffic, with the port built at
the configuration's `port_only` fields (`ptv3_form: "pointcept"`) and the
reference's refiner replaced by the plain PT-v3m1 (`reference/plain_ptv3m1`)
before the weights are drawn, so that one state_dict loads both.

The reference's configuration is the `model` fields alone (it has no
`ptv3_form`). After the heads are seeded, the refiner's offset layer, which
the reference init zeroes, is drawn N(0, heads.refine_std) like the heads:
with it at zero the refiner's output would never reach the gaussians, and
the check would not see the refiner.

The check splits the renderer at the refiner, as it splits the request
into stages, each from the program's own state: `offsets` (leaf) are the
reference's refine offsets (its upsampler, sampling, PT-v3m1 and refine
MLP, from the program's tokens and parameters) against the program's;
`gaussians` are the reference renderer's with the program's offsets in
place of its own. Without the split, a point moved by the refiner's bf16
error resamples the planes elsewhere, and the heads' small signal makes
the gaussians' gap read that movement many times over.
"""

from __future__ import annotations

import torch
from torch import nn

from ..reference import entry as ref
from ..reference.plain_ptv3m1 import PlainRefiner
from .common import dtype_of, port_body
from .serve import KINDS as SERVE_KINDS
from .serve import Driver as ServeDriver

KINDS = dict(SERVE_KINDS, offsets="leaf")


class Replay(nn.Module):
    """In the place of the reference renderer's refine MLP: keeps the
    reference's own offsets of each frame chunk and hands on the program's."""

    def __init__(self, mlp: nn.Module, program: list):
        super().__init__()
        self.mlp, self.program, self.own = mlp, program, []

    def forward(self, x):
        self.own.append(self.mlp(x))
        return self.program[len(self.own) - 1].to(x.device, x.dtype)


@torch.no_grad()
def stages(model, stat, got: dict, lowered: bool = False) -> dict:
    """`entry.serve_stages` with the renderer split at the refiner (the
    module's docstring)."""
    renderer = model.renderer
    mlp = renderer.refine_mlp
    replay = renderer.refine_mlp = Replay(mlp, got["offset_chunks"])
    try:
        out = ref.serve_stages(model, stat, got, lowered)
    finally:
        renderer.refine_mlp = mlp
    out["offsets"] = {"offsets": torch.cat(replay.own)}
    return out


class Driver(ServeDriver):
    kinds, stages = KINDS, staticmethod(stages)

    def setup(self) -> None:
        super().setup()
        self.hooks.append(self.rollout.model.renderer.refine_mlp.register_forward_hook(
            self._offsets))

    def _offsets(self, module, args, out):
        if self.recorder.keep is not None:
            self.recorder.keep.setdefault("offset_chunks", []).append(out)

    def check(self, count_work: bool = False, control: bool = False) -> dict:
        for s in self.samples:
            s["offsets"] = {"offsets": torch.cat(s["offset_chunks"])}
        return super().check(count_work, control)

    def build_port(self, build):
        from audio_motion_avatar_tpu_torch.models.config import AvatarConfig

        def body():
            self.body = ref.body(self.seed, **self.cell.config.get("body", {}))
            self.ref_cfg = ref.avatar_config(self.fields)
        self.timed("body", body)
        sd = self.timed("weights", lambda: self.reference().state_dict())
        fields = dict(self.fields, **self.cell.config["port_only"])
        cfg = AvatarConfig(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in fields.items()})

        def port():
            with torch.device(self.device):
                return build(cfg, device=self.device, dtype=dtype_of(self.fields),
                             smplx_model=port_body(self.body), state_dict=sd)
        return self.timed("build", port)

    def reference(self):
        """The reference model with the plain PT-v3m1 as its refiner and the
        seed's weights, on the device."""
        from ..weights import seed_heads, seed_parameters

        with torch.device(self.device):
            model = ref.build(self.kind, self.ref_cfg, self.body)
            model.renderer.point_refiner = PlainRefiner(self.ref_cfg).eval().requires_grad_(False)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        seed_parameters(model, gen)
        heads = self.cell.config["heads"]
        seed_heads(model, gen, heads)
        with torch.no_grad():
            w = model.renderer.refine_mlp[4].weight
            w.add_(torch.randn(w.shape, generator=gen, device=w.device) * heads["refine_std"])
        return model
