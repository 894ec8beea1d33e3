"""One stage-1 train step: the port against the JAX package.

The tiny TriplaneGaussianAvatar (AvatarConfig.tiny at 32x32, a 300-vertex
synthetic SMPL-X, its default render form with the point refiner) with
numpy-seeded parameters made visible (tests/test_torch_reconstruct.py), one
reference view and three test views. JAX: `stage1.make_train_step(...,
donate=False)` for the loss, grad_norm, the updated parameters and (an
optimizer that also records what it is given) the gradient of each leaf. The port: `train.build_trainer`
on the CPU from the same weights (weights.params_from_flax), its Sapiens
ViT returning the JAX image tokens (the ViT runs in bf16 on both sides and
rounds differently; it is frozen, so nothing differentiates through it).
Both run in fp32; the JAX renderer composites through its XLA tile route,
the port through CompositeTiles (the plain K1 and K2).

The ViT tokens are those of the ViT compiled alone: compiled inside the
step or run op by op, XLA rounds bf16 elsewhere, and bf16 noise in the
tokens moves the gradients by percents.

Tolerances: loss and grad_norm 1e-4 relative; every trainable gradient
leaf ||port - jax|| <= 1e-3 ||jax|| (sums reassociated through the whole
model and the splat's backward) plus a noise floor of 1e-7 of the global
gradient norm (leaves whose gradient is zero up to rounding); the
parameters after the Adam update as `params_close` states; frozen ViT
parameters unchanged and without gradient.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_motion_avatar_tpu.data.synthetic import make_batch as jmake_batch
from audio_motion_avatar_tpu.models.avatar import TriplaneGaussianAvatar as JaxAvatar
from audio_motion_avatar_tpu.models.config import AvatarConfig as JaxConfig
from audio_motion_avatar_tpu.models.ptv3 import build_point_refiner as jbuild_refiner
from audio_motion_avatar_tpu.models.renderer import build_renderer_statics as jstatics
from audio_motion_avatar_tpu.ops import smplx as jsmplx
from audio_motion_avatar_tpu.training import stage1 as jstage1
from audio_motion_avatar_tpu.training import train_state as jts

from audio_motion_avatar_tpu_torch.data.synthetic import make_batch, to_device
from audio_motion_avatar_tpu_torch.models.config import AvatarConfig
from audio_motion_avatar_tpu_torch.ops import smplx as tsmplx
from audio_motion_avatar_tpu_torch.train import build_trainer
from audio_motion_avatar_tpu_torch.training.train_state import OptimConfig
from audio_motion_avatar_tpu_torch.weights import params_from_flax
from torch_parity import one_torch_thread, random_params  # noqa: F401

SIZE = (32, 32)
LR = 1e-3


def _jax(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


def visible(params):
    """Visible gaussians: larger scale and opacity biases, small offsets."""
    r = params["renderer"]
    r["scaling_layer"]["bias"] = np.full(3, 1.5, np.float32)
    r["opacity_layer"]["bias"] = np.full(1, 2.0, np.float32)
    for name in ("xyz_layer", "rotation_layer", "scaling_layer", "opacity_layer", "shs_layer"):
        r[name]["kernel"] = (r[name]["kernel"] * 0.1).astype(np.float32)
    if "refine_mlp" in r:
        r["refine_mlp"]["layers_4"]["kernel"] *= 0.01
    return params


def recording(tx):
    """tx, whose state also keeps the last gradients it was given, so that
    one compiled train step yields the updated state and the gradients."""
    import optax

    def update(g, state, params=None):
        updates, inner = tx.update(g, state[0], params)
        return updates, (inner, g)

    return optax.GradientTransformation(
        lambda p: (tx.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)), update)


# XLA's CPU backend at its lowest optimisation level: the same program,
# compiled in about half the time
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def noise_floor(grads: dict) -> float:
    """The size of a gradient leaf that is zero up to rounding (a key bias
    under the softmax, a bias before a GroupNorm): 1e-7 of the global norm."""
    return 1e-7 * float(torch.sqrt(sum((g * g).sum() for g in grads.values())))


def leaves_close(got: dict, want: dict, rel=1e-3):
    """Every leaf of `want` (port layout) within rel of its norm, or under
    the noise floor."""
    assert set(got) == set(want), set(got) ^ set(want)
    floor = noise_floor(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        err, ref = float((g - w).norm()), float(w.norm())
        assert err <= rel * ref + floor, (k, err, ref)


def params_close(new, grads, want_new, lr=LR, clip=1.0):
    """Updated parameters agree to 1e-7 + 1e-5 |p| where Adam's first
    update lr g / (|g| + 1e-8) does not hang on the gradient's last digits
    (the clipped gradient g min(1, clip / ||g||) above 1000 times that
    epsilon, and |g| above 1e-3 of its leaf's largest, where the gradient
    is resolved; the leaf above the noise floor), and
    within 2 lr everywhere: there the update follows the sign of a gradient
    element that is all rounding."""
    floor = noise_floor(grads)
    scale = min(1.0, clip / (1e7 * floor))      # the clip's factor
    for k, w in want_new.items():
        d = (new[k] - w).abs()
        if k not in grads:                 # frozen: unchanged on both sides
            assert float(d.max()) == 0.0, k
            continue
        g = grads[k].abs()
        assert bool((d <= 2 * lr).all()), (k, float(d.max()))
        if float(g.norm()) <= floor:
            continue
        sig = (g * scale > 1e-5) & (g > 1e-3 * float(g.max()))
        assert bool((d[sig] <= 1e-7 + 1e-5 * w.abs()[sig]).all()), (k, float(d[sig].max()))


@pytest.fixture(scope="module")
def step_runs():
    jcfg = dataclasses.replace(JaxConfig.tiny(image_size=SIZE), frames_scan_remat=False)
    jmodel = jsmplx.synthetic_model(seed=0, num_verts=300)
    statics = jstatics(jmodel, subdivide_steps=jcfg.subdivide_steps,
                       densify=jcfg.densify_smplx_verts)
    nverts = 300 + np.asarray(jmodel.faces).shape[0]
    model = JaxAvatar(cfg=jcfg, num_verts_encoder=nverts, point_refiner=jbuild_refiner(jcfg))
    ref, test = jmake_batch(1, 1, SIZE, seed=40), jmake_batch(1, 3, SIZE, seed=41)
    jref, jtest = _jax(ref), _jax(test)
    params = visible(random_params(model, 42, statics, jref.video, jref.smpl_parms,
                                   jref.cam_parms))
    optim = dict(learning_rate=LR, total_steps=100)
    state = jts.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                                  recording(jts.make_optimizer(jts.OptimConfig(**optim))))
    step = jstage1.make_train_step(model, statics, jcfg, with_test_views=True, donate=False)
    new_state, metrics = step.lower(state, jref, jtest).compile(
        compiler_options=FAST_COMPILE)(state, jref, jtest)
    grads = new_state.opt_state[1]
    tokens = jax.jit(lambda p, v: model.apply(
        {"params": p}, v, method=lambda m, x: m.sapiens_encoder(x.reshape((-1,) + x.shape[2:]))))(
        state.params, jref.video)

    tr = build_trainer(1, AvatarConfig.tiny(image_size=SIZE), device="cpu",
                       smplx_model=tsmplx.synthetic_model(seed=0, num_verts=300),
                       state_dict=params_from_flax(params), optim=OptimConfig(**optim))
    flat = torch.tensor(np.asarray(tokens))
    tr.model.sapiens_encoder.forward = lambda images: flat
    old = {k: p.detach().clone() for k, p in tr.model.named_parameters()}
    got = tr.step(to_device(make_batch(1, 1, SIZE, seed=40), "cpu"),
                  to_device(make_batch(1, 3, SIZE, seed=41), "cpu"))
    np_ = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return dict(tr=tr, old=old, got=got, metrics={k: float(v) for k, v in metrics.items()},
                grads=params_from_flax(np_(grads)), new=params_from_flax(np_(new_state.params)))


def test_loss_and_grad_norm_match(step_runs):
    got, want = step_runs["got"], step_runs["metrics"]
    for k in ("loss", "grad_norm", "l1_train", "l1_test", "ssim_train", "ssim_test",
              "smplx_param_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert want["grad_norm"] > 0


def test_trainable_gradients_match(step_runs):
    tr, want = step_runs["tr"], step_runs["grads"]
    got = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
           for k, p in tr.model.named_parameters() if not k.startswith("sapiens_encoder")}
    leaves_close(got, {k: v for k, v in want.items() if not k.startswith("sapiens_encoder")})
    moved = [k for k, v in want.items() if float(v.abs().max()) > 0]
    assert any(k.startswith("renderer.") for k in moved)
    assert any(k.startswith("fusion_network.") for k in moved)
    assert any(k.startswith("smplx_triplane_encoder.") for k in moved)


def test_params_after_update_match(step_runs):
    tr, want, grads = step_runs["tr"], step_runs["new"], step_runs["grads"]
    new = {k: p.detach() for k, p in tr.model.named_parameters()}
    params_close(new, grads, want)
    assert any(not torch.equal(new[k], step_runs["old"][k]) for k in new)


def test_frozen_vit_has_no_gradient_and_stays(step_runs):
    """Repair: the Sapiens ViT runs without autograd, so training never
    reaches its parameters (the JAX package's stop_gradient)."""
    tr, old = step_runs["tr"], step_runs["old"]
    vit = dict(tr.model.sapiens_encoder.named_parameters(prefix="sapiens_encoder"))
    assert vit and all(p.grad is None for p in vit.values())
    assert all(torch.equal(p, old[k]) for k, p in vit.items())
    assert not any(k.startswith("sapiens_encoder") for k in tr.state.trainable)


def test_vit_frozen_under_a_real_train_step():
    """Repair: with the ViT itself running (bf16, as the model's own
    setting), a train step leaves every ViT parameter without a gradient
    and unchanged, and its tokens carry no gradient."""
    tr = build_trainer(1, AvatarConfig.tiny(image_size=SIZE), device="cpu",
                       smplx_model=tsmplx.synthetic_model(seed=0, num_verts=300),
                       optim=OptimConfig(learning_rate=LR, accumulate_steps=1))
    vit = tr.model.sapiens_encoder
    before = [p.detach().clone() for p in vit.parameters()]
    ref = to_device(make_batch(1, 1, SIZE, seed=43), "cpu")
    assert not vit(ref.video[:, 0]).requires_grad
    metrics = tr.step(ref, to_device(make_batch(1, 2, SIZE, seed=44), "cpu"))
    assert np.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
    assert all(p.grad is None for p in vit.parameters())
    assert all(torch.equal(p, b) for p, b in zip(vit.parameters(), before))
