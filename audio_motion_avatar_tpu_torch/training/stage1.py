"""Stage-1 evaluation: the JAX package's `stage1_loss` forward, no gradient.

    loss = [l1 + 0.1 (1 - ssim)](reference views)
         + [l1 + 0.1 (1 - ssim)](the reference frame's gaussians rendered
                                 from the test cameras)
         + 0.01 (smplx_param_loss(pred_1) + smplx_param_loss(pred_2))

plus the gaussian heads' health statistics. The novel views go through
`splat_tiles.render_multi_view`: every test view of the batch in one
composite launch (kernel K1 on the card).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..data.synthetic import VideoBatch
from ..ops.splat_tiles import render_multi_view
from ..utils import losses as L


@torch.no_grad()
def stage1_loss(model, statics, ref_batch: VideoBatch,
                test_batch: Optional[VideoBatch], cfg):
    """model: models.avatar.TriplaneGaussianAvatar; batches of tensors on
    the model's device (data.synthetic.to_device). Returns (loss, metrics,
    avatar output, novel views (B, T_test, H, W, 3) or None)."""
    ref_video = ref_batch.video
    out = model(statics, ref_video, ref_batch.smpl_parms, ref_batch.cam_parms)
    ref_hwc = ref_video.permute(0, 1, 3, 4, 2)
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
        novel = render_multi_view(gaussians_b, test_batch.cam_parms["intrinsic"],
                                  test_batch.cam_parms["extrinsic"], W, H,
                                  max_per_tile=cfg.max_per_tile)
        test_hwc = test_batch.video.permute(0, 1, 3, 4, 2)
        l1_test = L.l1_loss(novel, test_hwc)
        ssim_test = 1.0 - L.ssim(novel, test_hwc)
        loss = loss + l1_test + 0.1 * ssim_test
        metrics.update(l1_test=l1_test, ssim_test=ssim_test)

    op = out.gaussians["opacity"].float()
    sc = out.gaussians["scale"].float()
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


def make_render_fn(model, statics):
    """ref_batch -> (rendered (B, T, H, W, 3), target (B, T, H, W, 3))."""

    @torch.no_grad()
    def fn(ref_batch: VideoBatch):
        out = model(statics, ref_batch.video, ref_batch.smpl_parms,
                    ref_batch.cam_parms)
        return out.rendered_images, ref_batch.video.permute(0, 1, 3, 4, 2)

    return fn
