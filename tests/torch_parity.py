"""Helpers shared by the PyTorch port's parity tests (tests/test_torch_*.py).

Parameters are drawn with numpy from a seed in the flax tree's own layout,
run through the JAX module as they are and through its PyTorch counterpart
after `weights.convert_subtree` / `weights.params_from_flax`, so both sides
compute with the same numbers.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from audio_motion_avatar_tpu.parallel.mesh import unbox
from audio_motion_avatar_tpu_torch.weights import convert_subtree


def random_leaf(path, shape, rng):
    """Fan-in scaled random weights, norm scales near 1, small biases."""
    name = path[-1].key
    if name == "scale":
        a = 1.0 + 0.1 * rng.randn(*shape)
    elif name.endswith("bias"):
        a = 0.1 * rng.randn(*shape)
    else:
        parent = path[-2].key if len(path) > 1 else ""
        if len(shape) == 4:                        # HWIO conv
            fan_in = shape[0] * shape[1] * shape[2]
        elif len(shape) == 3 and parent == "out":  # (H, D, C)
            fan_in = shape[0] * shape[1]
        elif name == "time_kernel":                # (3, C, T)
            fan_in = shape[-1]
        elif name == "kernel" and parent == "cpe":  # (3, 1, C)
            fan_in = 3
        else:
            fan_in = shape[0]
        a = rng.randn(*shape) / np.sqrt(fan_in)
    return np.asarray(a, np.float32)


def random_params(module, seed, *args, method=None):
    """A numpy parameter tree with the structure of `module.init(*args)`,
    drawn from `seed` (the init itself is only traced, never run)."""
    variables = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, method=method))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: random_leaf(path, s.shape, rng),
        unbox(variables)["params"])


def jax_serving_avatar(smplx_model, **overrides):
    """The JAX stage-2 serving model at the tiny test profile (32x32) with
    the serving profile applied, then `overrides`: (cfg, model, chunk) where
    chunk(module, tri, smpl, audio, cams, render=True) is one serving chunk
    (audio rollout -> shared SMPL-X decoder -> renderer), as
    tools/serve_bench.py's chunk_step."""
    from audio_motion_avatar_tpu.configs.build import (SERVING_PROFILE,
                                                       SERVING_PROFILE_MODEL)
    from audio_motion_avatar_tpu.models.audio_avatar import AudioDrivenAvatar
    from audio_motion_avatar_tpu.models.config import AvatarConfig
    from audio_motion_avatar_tpu.models.ptv3 import build_point_refiner
    from audio_motion_avatar_tpu.models.renderer import build_renderer_statics
    from audio_motion_avatar_tpu.models.triplane_encoder import reshape_params

    over = dict(SERVING_PROFILE, **SERVING_PROFILE_MODEL,
                audio_transformer_remat=False, frames_scan_unroll=1)
    over.update(overrides)
    cfg = dataclasses.replace(AvatarConfig.tiny(image_size=(32, 32)), **over)
    statics = build_renderer_statics(smplx_model, subdivide_steps=cfg.subdivide_steps,
                                     densify=cfg.densify_smplx_verts)
    nverts = int(smplx_model.v_template.shape[0]) + int(np.asarray(smplx_model.faces).shape[0])
    model = AudioDrivenAvatar(cfg=cfg, num_verts_encoder=nverts,
                              point_refiner=None if cfg.no_point_refiner
                              else build_point_refiner(cfg))

    def chunk(mdl, tri, smpl, aud, cam, render=True):
        out_tri, out_smpl = mdl.audio_triplane(aud, tri, smpl)
        Bc, T = out_smpl.shape[:2]
        flat = out_smpl.reshape((Bc * T,) + out_smpl.shape[2:])
        pred = reshape_params(mdl.triplane_gaussian.encoder.smpl_decoder(flat), (Bc, T))
        rendered, _ = mdl.triplane_gaussian.renderer(statics, out_tri, cam, pred,
                                                     render=render)
        return rendered, out_tri, out_smpl, pred

    return cfg, model, chunk


def load_flax(module: torch.nn.Module, params: dict) -> torch.nn.Module:
    """Load one flax module's params into its torch twin (strict)."""
    module.load_state_dict(convert_subtree(params), strict=True)
    return module.eval()


def t(a) -> torch.Tensor:
    """numpy / JAX array -> CPU float tensor (a copy)."""
    return torch.tensor(np.asarray(a))


def flax_from_state_dict(template: dict, state_dict: dict, prefix: str = "") -> dict:
    """The inverse of weights.params_from_flax on one subtree: a flax-layout
    tree shaped as `template` (nested dicts of arrays, the module at
    `prefix` in the port) holding the values of the port's `state_dict`.
    Every rule there is a relayout, so each leaf's layout is inverted by
    converting the array of its flat indices."""
    from audio_motion_avatar_tpu_torch.weights import _entry

    def leaf(path, a):
        shape = np.shape(a)
        key, idx = _entry(prefix, path, np.arange(int(np.prod(shape))).reshape(shape))
        out = np.empty(int(np.prod(shape)), np.float32)
        out[idx.numpy().astype(np.int64).ravel()] = \
            state_dict[key].detach().float().cpu().numpy().ravel()
        return out.reshape(shape)

    def walk(tree, path=()):
        return {k: walk(v, path + (k,)) if isinstance(v, dict) else leaf(path + (k,), v)
                for k, v in tree.items()}

    return walk(template)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for the module's tests, restored after:
    the tier-1 run keeps every core busy with its workers, where extra
    threads only spin (the demo test alone on an 8-core CPU: 73 s of CPU
    time with one thread, 126 s with eight, for nearly the same wall time).
    Import it into a test module to use it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
