"""PyTorch + CUDA port of the audio-driven avatar: the stage-2 demo
(`python -m audio_motion_avatar_tpu_torch.main2 --mode demo`), the serving
rollout, the stage-1 reconstruction and one train step of each stage.

The JAX package `audio_motion_avatar_tpu` beside this one stays the
reference; module names here mirror it so each counterpart is easy to find.
This package imports torch and never jax, flax or the JAX package.

Entry points run on CUDA unless the caller passes `device="cpu"`; without a
card they raise instead of falling back. The hand-written Hopper kernels
live in `csrc/` and are built on first use (`kernels.py`); each wrapper
takes its plain PyTorch version only for CPU tensors.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
