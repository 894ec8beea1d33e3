"""What the drivers share: the set-up from the seed (`SeededDriver`), the
sampler of the requests that are compared, and the staged check."""

from __future__ import annotations

import random
import sys
import time
from typing import List, Optional


def model_fields(cell) -> dict:
    """The configuration's `model` fields with the traffic's overrides
    (`image_size`: the frame size the requests ask for)."""
    fields = dict(cell.config["model"])
    if "image_size" in cell.traffic:
        fields["image_size"] = list(cell.traffic["image_size"])
    return fields


def port_body(body):
    """The benchmark's numpy SMPL-X body as the port's own container."""
    from audio_motion_avatar_tpu_torch.ops.smplx import SmplxModel

    return SmplxModel(*body)


class Sampler:
    """Which requests of a window are compared: the first (the start) and
    `k - 1` drawn uniformly from the rest by reservoir sampling, the draws
    from the seed. `slot(i)` is called before request i runs and returns a
    dict to fill with its inputs and answer, or None."""

    def __init__(self, seed: int, k: int):
        self.rng = random.Random(seed)
        self.k = k
        self.first: Optional[dict] = None
        self.rest: List[dict] = []

    def slot(self, i: int) -> Optional[dict]:
        if i == 0:
            self.first = {"index": 0}
            return self.first
        room = self.k - 1
        if room <= 0:
            return None
        if len(self.rest) < room:
            self.rest.append({"index": i})
            return self.rest[-1]
        j = self.rng.randrange(i)      # request i replaces one with chance room / i
        if j < room:
            self.rest[j] = {"index": i}
            return self.rest[j]
        return None

    def kept(self) -> List[dict]:
        out = ([self.first] if self.first else []) + sorted(self.rest, key=lambda s: s["index"])
        return out


def dtype_of(fields: dict):
    """The compute dtype the configuration states, as a torch dtype."""
    import torch

    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[fields["compute_dtype"]]


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    import torch

    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def move(obj, device):
    """`obj` with every tensor in it (inside dicts, lists, tuples and named
    tuples) on `device`."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: move(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(move(v, device) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(move(v, device) for v in obj)
    return obj


def to_host(slot: dict) -> float:
    """Move a sampled request's kept inputs and answer to host memory, in
    place, so that the window's peak is the program's own; the seconds it
    took, which the window leaves out."""
    t = time.perf_counter()
    for k, v in slot.items():
        slot[k] = move(v, "cpu")
    return time.perf_counter() - t


def free(device) -> None:
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def check_stages(stages, model, stat, samples, kinds, count_work, config=None) -> dict:
    """`stages(model, stat, sample)` for every sampled request against what
    the program answered: {"gaps": ...}; with count_work the first
    request's kernel calls ("calls") and counted FLOPs ("flops"); with the
    configuration the control's gaps too ("control_gaps"), the model then
    lowered in its `bf16_modules` and `fp32_matmul_modules`."""
    from ..compare import worst
    from ..reference.entry import lower_precision
    from ..reference.plain_avatar.ops.calls import record
    from ..work import counted_flops

    def follow(s):
        """The reference's stages from the program's state; None where
        that state is malformed (not the shapes the stages take)."""
        try:
            return stages(model, stat, s)
        except (RuntimeError, ValueError, IndexError) as e:
            print(f"[check] request {s['index']}: the program's state does not fit the "
                  f"reference's stages: {e}", file=sys.stderr, flush=True)
            return None

    got = [{k: s[k] for k in kinds} for s in samples]
    want, out = [], {}
    for j, s in enumerate(samples):
        if j == 0 and count_work:
            with record() as log:
                out["flops"] = counted_flops(lambda: want.append(follow(s)))
            out["calls"] = dict(log)
        else:
            want.append(follow(s))
    out["gaps"] = worst(kinds, got, want)
    if config is not None:
        with lower_precision(model, config["bf16_modules"], config["fp32_matmul_modules"]):
            ctl = [stages(model, stat, s, lowered=True) for s in samples]
        out["control_gaps"] = worst(kinds, ctl, want)
    return out


class SeededDriver:
    """A driver's set-up from the seed: the synthetic body, the reference
    model seeded on the device (its state_dict is the port's weights), and
    the port built from them under the device as default. Subclasses name
    the reference's `kind` and `stages`, and set up and run their traffic."""

    kind: str
    elem_bytes = 2   # bf16 operands

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.traffic = cell.traffic
        self.fields = model_fields(cell)
        self.parts = {}

    def timed(self, part: str, fn):
        """fn(), its seconds kept as set-up part `part`."""
        t = time.perf_counter()
        out = fn()
        self.parts[part] = time.perf_counter() - t
        return out

    def setup_parts(self) -> str:
        return ", ".join(f"{k} {v:.3f} s" for k, v in self.parts.items())

    def reference(self):
        """The reference model with the seed's weights, on the device."""
        import torch

        from ..reference import entry as ref
        from ..weights import seed_heads, seed_parameters

        with torch.device(self.device):
            model = ref.build(self.kind, self.ref_cfg, self.body)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        seed_parameters(model, gen)
        seed_heads(model, gen, self.cell.config["heads"])
        return model

    def build_port(self, build):
        """`build(cfg, device=, dtype=, smplx_model=, state_dict=)` of the
        port (serve.build_rollout or reconstruct.build_reconstructor) with
        the seed's body and weights."""
        import torch

        from audio_motion_avatar_tpu_torch.models.config import AvatarConfig

        from ..reference import entry as ref

        def body():
            self.body = ref.body(self.seed, **self.cell.config.get("body", {}))
            self.ref_cfg = ref.avatar_config(self.fields)
        self.timed("body", body)
        sd = self.timed("weights", lambda: self.reference().state_dict())
        cfg = AvatarConfig(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in self.fields.items()})

        def port():
            with torch.device(self.device):
                return build(cfg, device=self.device, dtype=dtype_of(self.fields),
                             smplx_model=port_body(self.body), state_dict=sd)
        return self.timed("build", port)

    def check(self, count_work: bool = False, control: bool = False) -> dict:
        """The sampled requests against the reference, stage by stage (see
        reference.entry); with `control`, the control's gaps too."""
        from ..reference import entry as ref

        stat = ref.statics(self.ref_cfg, self.body, self.device)
        samples = [move(s, self.device) for s in self.samples]
        return check_stages(self.stages, self.reference(), stat, samples, self.kinds,
                            count_work, self.cell.config if control else None)
