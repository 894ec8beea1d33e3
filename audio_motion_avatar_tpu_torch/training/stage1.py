"""Stage-1 training and evaluation (the JAX package's training/stage1.py).

    loss = [l1 + 0.1 (1 - ssim)](reference views)
         + [l1 + 0.1 (1 - ssim)](the reference frame's gaussians rendered
                                 from the test cameras)
         + 0.01 (smplx_param_loss(pred_1) + smplx_param_loss(pred_2))

plus the gaussian heads' health statistics. The novel views go through
`splat_tiles.render_multi_view`: every test view of the batch in one
composite launch (kernel K1 on the card; under autograd K2 for its
gradient). `stage1_loss` is differentiable; `make_train_step` runs it,
backpropagates (the frozen Sapiens ViT gets no gradient) and applies the
optimizer; `Reconstructor` (reconstruct.py) and `make_eval_step` run it
without autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..data.synthetic import VideoBatch
from ..ops.splat_tiles import render_multi_view
from ..utils import losses as L
from ..utils import profiling
from .train_state import TrainState, check_differentiable


def stage1_loss(model, statics, ref_batch: VideoBatch,
                test_batch: Optional[VideoBatch], cfg):
    """model: models.avatar.TriplaneGaussianAvatar; batches of tensors on
    the model's device (data.synthetic.to_device). Returns (loss, metrics,
    avatar output, novel views (B, T_test, H, W, 3) or None)."""
    ref_video = ref_batch.video
    out = model(statics, ref_video, ref_batch.smpl_parms, ref_batch.cam_parms)
    ref_hwc = ref_video.permute(0, 1, 3, 4, 2)
    with profiling.span("recon.loss"):
        l1_train = L.l1_loss(out.rendered_images, ref_hwc)
        ssim_train = 1.0 - L.ssim(out.rendered_images, ref_hwc)
    loss = l1_train + 0.1 * ssim_train
    metrics = {"l1_train": l1_train, "ssim_train": ssim_train}

    novel = None
    if test_batch is not None:
        B = ref_video.shape[0]
        gaussians_b = {k: v.reshape((B, -1) + v.shape[1:])[:, 0]
                       for k, v in out.gaussians.items() if k != "shs"}
        H, W = cfg.image_size
        with profiling.span("recon.novel"):
            novel = render_multi_view(gaussians_b, test_batch.cam_parms["intrinsic"],
                                      test_batch.cam_parms["extrinsic"], W, H,
                                      max_per_tile=cfg.max_per_tile,
                                      sh_degree=None if cfg.rgb else cfg.sh_degree)
        test_hwc = test_batch.video.permute(0, 1, 3, 4, 2)
        with profiling.span("recon.loss"):
            l1_test = L.l1_loss(novel, test_hwc)
            ssim_test = 1.0 - L.ssim(novel, test_hwc)
        loss = loss + l1_test + 0.1 * ssim_test
        metrics.update(l1_test=l1_test, ssim_test=ssim_test)

    op = out.gaussians["opacity"].detach().float()
    sc = out.gaussians["scale"].detach().float()
    metrics.update(
        opacity_logit_mean=op.mean(), opacity_logit_min=op.min(),
        opacity_logit_max=op.max(), opacity_act_mean=torch.sigmoid(op).mean(),
        scale_logit_mean=sc.mean(),
        scale_act_mean=torch.clamp(torch.exp(sc - 3.9), max=0.1).mean())

    loss_smplx = 0.0
    for pred in (out.pred_smpl_1, out.pred_smpl_2):
        if pred is not None:
            loss_smplx = loss_smplx + L.smplx_param_loss(pred, ref_batch.smpl_parms)[0]
    metrics["smplx_param_loss"] = loss_smplx
    loss = loss + 0.01 * loss_smplx
    metrics["loss"] = loss
    return loss, metrics, out, novel


def make_train_step(model, statics, cfg, with_test_views: bool = True):
    """(state: TrainState, ref_batch, test_batch) -> (state, metrics): the
    loss, its backward and one optimizer call (an accumulation mini-step
    under accumulate_steps > 1). metrics: detached scalars, with grad_norm
    the gradients' global norm before clipping. Raises on a configuration
    whose render path has a forward-only kernel."""
    check_differentiable(cfg)

    def step(state: TrainState, ref_batch: VideoBatch,
             test_batch: Optional[VideoBatch]):
        state.zero_grad()
        loss, metrics, _, _ = stage1_loss(
            state.model, statics, ref_batch,
            test_batch if with_test_views else None, cfg)
        loss.backward()
        grads = state.grads()
        metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
        metrics = state.global_metrics(metrics)
        metrics["grad_norm"] = state.grad_norm(grads).detach()
        state.apply_gradients(grads)
        return state, metrics

    return step


def make_eval_step(model, statics, cfg):
    """(ref_batch, test_batch) -> the stage-1 metrics, without autograd."""

    @torch.no_grad()
    def step(ref_batch: VideoBatch, test_batch: Optional[VideoBatch]):
        return stage1_loss(model, statics, ref_batch, test_batch, cfg)[1]

    return step


def make_render_fn(model, statics):
    """ref_batch -> (rendered (B, T, H, W, 3), target (B, T, H, W, 3))."""

    @torch.no_grad()
    def fn(ref_batch: VideoBatch):
        out = model(statics, ref_batch.video, ref_batch.smpl_parms,
                    ref_batch.cam_parms)
        return out.rendered_images, ref_batch.video.permute(0, 1, 3, 4, 2)

    return fn
