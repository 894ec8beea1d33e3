"""The stage-1 loss and metrics (the port's training/stage1.py, forward
only).

    loss = [l1 + 0.1 (1 - ssim)](reference views)
         + [l1 + 0.1 (1 - ssim)](the reference frame's gaussians rendered
                                 from the test cameras)
         + 0.01 (smplx_param_loss(pred_1) + smplx_param_loss(pred_2))

plus the gaussian heads' health statistics. `stage1_metrics` computes
them from a forward's outputs (the program's, in the check).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..data.containers import VideoBatch
from ..ops.splat_tiles import render_multi_view
from ..utils import losses as L


def render_novel(gaussians: dict, test_batch: VideoBatch, cfg) -> torch.Tensor:
    """The reference frame's gaussians (B*T, N, ...) rendered from every
    test camera: (B, T_test, H, W, 3)."""
    B = test_batch.cam_parms["intrinsic"].shape[0]
    gaussians_b = {k: v.reshape((B, -1) + v.shape[1:])[:, 0]
                   for k, v in gaussians.items() if k != "shs"}
    H, W = cfg.image_size
    return render_multi_view(gaussians_b, test_batch.cam_parms["intrinsic"],
                             test_batch.cam_parms["extrinsic"], W, H,
                             max_per_tile=cfg.max_per_tile)


def stage1_metrics(rendered, novel, gaussians: dict, pred_1, pred_2,
                   ref_batch: VideoBatch, test_batch: Optional[VideoBatch]) -> dict:
    """The stage-1 loss and its metrics from a forward's outputs."""
    ref_hwc = ref_batch.video.permute(0, 1, 3, 4, 2)
    l1_train = L.l1_loss(rendered, ref_hwc)
    ssim_train = 1.0 - L.ssim(rendered, ref_hwc)
    loss = l1_train + 0.1 * ssim_train
    metrics = {"l1_train": l1_train, "ssim_train": ssim_train}
    if test_batch is not None:
        test_hwc = test_batch.video.permute(0, 1, 3, 4, 2)
        l1_test = L.l1_loss(novel, test_hwc)
        ssim_test = 1.0 - L.ssim(novel, test_hwc)
        loss = loss + l1_test + 0.1 * ssim_test
        metrics.update(l1_test=l1_test, ssim_test=ssim_test)

    op = gaussians["opacity"].detach().float()
    sc = gaussians["scale"].detach().float()
    metrics.update(
        opacity_logit_mean=op.mean(), opacity_logit_min=op.min(),
        opacity_logit_max=op.max(), opacity_act_mean=torch.sigmoid(op).mean(),
        scale_logit_mean=sc.mean(),
        scale_act_mean=torch.clamp(torch.exp(sc - 3.9), max=0.1).mean())

    loss_smplx = 0.0
    for pred in (pred_1, pred_2):
        if pred is not None:
            loss_smplx = loss_smplx + L.smplx_param_loss(pred, ref_batch.smpl_parms)[0]
    metrics["smplx_param_loss"] = loss_smplx
    loss = loss + 0.01 * loss_smplx
    metrics["loss"] = loss
    return metrics
