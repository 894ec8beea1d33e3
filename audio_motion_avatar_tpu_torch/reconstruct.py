"""Stage-1 reconstruction: the port's counterpart of `main.py --mode
test|predict`.

`build_reconstructor(cfg, device, dtype)` builds the stage-1 model
(TriplaneGaussianAvatar) and its renderer statics; the returned
`Reconstructor` maps a reference batch (video, SMPL-X params, cameras) and
an optional batch of test cameras and target images to the rendered
reference views, the novel views, the gaussians and the `stage1_loss`
metrics (training/stage1.py, run without autograd). Each call is one
request of the port's tracer (utils/profiling.py: `recon.request`, its
novel views `recon.novel`, its losses and read-back `recon.loss`).

The Sapiens ViT runs in bf16 whatever the config says; the triplane
encoder's SMPL-X predictor, the fusion transformer, the upsampler and the
refiner run in cfg.compute_dtype (bf16 on the card with 64-wide heads:
kernel A takes bf16 operands); geometry and splatting run in fp32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .data.synthetic import VideoBatch
from .device import resolve_device
from .models.avatar import AvatarOutput, TriplaneGaussianAvatar
from .models.config import AvatarConfig
from .models.renderer import RendererStatics, build_renderer_statics
from .ops import smplx as smplx_ops
from .serve import check_kernel_dtype, num_verts_encoder, with_dtype
from .training.stage1 import stage1_loss
from .utils import profiling
from .utils.losses import psnr
from .weights import init_weights


class Reconstruction(NamedTuple):
    reference: torch.Tensor             # (B, T, H, W, 3) rendered reference views
    novel: Optional[torch.Tensor]       # (B, T_test, H, W, 3) or None
    gaussians: dict                     # (B*T, N, ...)
    metrics: dict                       # stage1_loss metrics + PSNRs, floats
    output: AvatarOutput


class Reconstructor:
    """One reconstruction per call, on the model's device."""

    def __init__(self, model: TriplaneGaussianAvatar, statics: RendererStatics,
                 device: torch.device):
        self.model, self.statics, self.device = model, statics, device
        self.cfg = model.cfg

    @torch.no_grad()
    def __call__(self, ref_batch: VideoBatch,
                 test_batch: Optional[VideoBatch] = None) -> Reconstruction:
        """Batches of tensors on the model's device (data.synthetic.to_device):
        ref video (B, T, 3, H, W) in [0, 1]; test_batch: the test cameras
        (B, T_test, ...) and their target images."""
        with profiling.request("recon.request", self.device):
            _, metrics, out, novel = stage1_loss(self.model, self.statics, ref_batch,
                                                 test_batch, self.cfg)
            with profiling.span("recon.loss"):
                metrics = {k: read_back(v) for k, v in metrics.items()}
                ref_hwc = ref_batch.video.permute(0, 1, 3, 4, 2)
                metrics["psnr_train"] = read_back(psnr(out.rendered_images, ref_hwc))
                if novel is not None:
                    metrics["psnr_test"] = read_back(
                        psnr(novel, test_batch.video.permute(0, 1, 3, 4, 2)))
            return Reconstruction(out.rendered_images, novel, out.gaussians, metrics, out)


def read_back(value) -> float:
    """A metric as a Python float. A tensor's read-back, a host sync on the
    card, is counted at site "recon.metrics" (utils/profiling.py)."""
    if not torch.is_tensor(value):
        return float(value)
    with profiling.host_sync("recon.metrics"):
        return float(value)


def build_reconstructor(cfg: AvatarConfig, device=None,
                        dtype: Optional[torch.dtype] = None,
                        smplx_model: Optional[smplx_ops.SmplxModel] = None,
                        seed: int = 0,
                        state_dict: Optional[dict] = None) -> Reconstructor:
    """Stage-1 model on `device` (CUDA unless "cpu" is asked for).

    dtype: compute dtype of the predictor / fusion / upsampler / refiner
    stacks (torch.bfloat16 on the card; None keeps cfg.compute_dtype); an
    fp32 configuration with 64-wide heads raises on the card. Weights come
    from `state_dict` (weights.params_from_flax of a TriplaneGaussianAvatar
    tree) or a seeded init. smplx_model: numpy SMPL-X model (default: the
    synthetic stand-in)."""
    device = resolve_device(device)
    cfg = with_dtype(cfg, dtype)
    check_kernel_dtype(cfg, device, stage1=True)
    if smplx_model is None:
        smplx_model = smplx_ops.synthetic_model(seed=0)
    model = TriplaneGaussianAvatar(cfg, num_verts_encoder(smplx_model))
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init_weights(model, seed)
    model.to(device).eval()
    statics = build_renderer_statics(smplx_model, device,
                                     subdivide_steps=cfg.subdivide_steps,
                                     densify=cfg.densify_smplx_verts)
    return Reconstructor(model, statics, device)
