"""Stage-2 training: audio-driven motion generation (the JAX package's
training/stage2.py).

    loss = 10 [l1 + 0.1 (1 - ssim)](audio-rendered frames)
         + 0.05 smplx_param_loss(pred_future)

plus the prediction-cache curriculum: with probability
cache_replacement_prob the fresh stage-1 tokens are replaced by the model's
own predictions cached 12 frames earlier, bounded at 30 self-feeding
iterations, and each step's last-2-frame predictions are written back under
batch_id + 12. The cache is host-side state (PredictionCache, with the JAX
package's random.Random draws) holding its entries in host memory, as the
JAX package's np.asarray does: a step's device keeps nothing of it, and
Stage2TrainLoop moves a hit back to the step's device. The swap is
models.audio_avatar's flag * cached + (1 - flag) * fresh. The stage-1
reconstruction runs without autograd, so only the audio net, the shared
SMPL-X decoder and the shared renderer get gradients. The cache lives in
one process: the cross-process cache sync is not ported.
"""

from __future__ import annotations

import random
from typing import Optional

import torch

from ..data.synthetic import VideoBatch
from ..utils import losses as L
from .train_state import TrainState, check_differentiable, global_norm

CACHE_FUTURE_OFFSET = 12
CACHE_MAX_ITERS = 30


class PredictionCache:
    """Host-side {(subject, frame): {triplane, smplx_tokens, iter}} store;
    the tokens are CPU tensors."""

    def __init__(self, replacement_prob: float = 0.0, seed: int = 0):
        self.store = {}
        self.prob = replacement_prob
        self.rng = random.Random(seed)

    def maybe_get(self, batch_id: int, subject_id: int = 0):
        """Returns (use_cache: bool, triplane, smplx_tokens, iter)."""
        if self.prob > 0 and self.rng.random() < self.prob:
            item = self.store.get((subject_id, batch_id))
            if item is not None:
                return True, item["triplane"], item["smplx_tokens"], item["iter"]
        return False, None, None, 0

    def put(self, batch_id: int, out_tri, out_smpl, iter_count: int,
            subject_id: int = 0):
        if self.prob <= 0 or iter_count >= CACHE_MAX_ITERS:
            return None
        key = (subject_id, batch_id + CACHE_FUTURE_OFFSET)
        item = {"triplane": out_tri[:, -2:].detach().to("cpu", copy=True),
                "smplx_tokens": out_smpl[:, -2:].detach().to("cpu", copy=True),
                "iter": iter_count + 1}
        self.store[key] = item
        return {key: item}


def stage2_loss(model, statics, ref_batch: VideoBatch, target_batch: VideoBatch,
                cached_tri, cached_smpl, use_cache_flag, cfg):
    """Returns (total, (metrics, AudioAvatarOutput))."""
    out = model(statics, ref_batch.video, ref_batch.smpl_parms,
                ref_batch.cam_parms, target_batch.audio_features,
                target_batch.cam_parms, cached_triplanes=cached_tri,
                cached_smpl_tokens=cached_smpl, use_cache=use_cache_flag,
                render_ref=True)
    target_hwc = target_batch.video.permute(0, 1, 3, 4, 2)
    l1 = L.l1_loss(out.rendered_images, target_hwc)
    ssim = 1.0 - L.ssim(out.rendered_images, target_hwc)
    loss_target = l1 + 0.1 * ssim
    smpl_future = L.smplx_param_loss(out.pred_smplx_future,
                                     target_batch.smpl_parms)[0]
    total = 10.0 * loss_target + 0.05 * smpl_future
    metrics = {"l1_target": l1, "ssim_target": ssim, "loss_target": loss_target,
               "smpl_loss_future": smpl_future, "loss": total}
    return total, (metrics, out)


def make_train_step(model, statics, cfg):
    """(state, ref_batch, target_batch, cached_tri, cached_smpl, use_cache
    (B,)) -> (state, metrics, out_tri, out_smpl, rendered, ref_rendered).
    metrics: detached scalars, plus grad_norm (the gradients' global norm
    before clipping). Raises on a render path with a forward-only kernel."""
    check_differentiable(cfg)

    def step(state: TrainState, ref_batch, target_batch, cached_tri,
             cached_smpl, use_cache_flag):
        state.zero_grad()
        loss, (metrics, out) = stage2_loss(state.model, statics, ref_batch,
                                           target_batch, cached_tri, cached_smpl,
                                           use_cache_flag, cfg)
        loss.backward()
        grads = state.grads()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads.values()).detach()
        state.apply_gradients(grads)
        return (state, metrics, out.output_triplane_tokens.detach(),
                out.output_smpl_tokens.detach(), out.rendered_images.detach(),
                out.ref_rendered)

    return step


def cache_depth_channels(l1_value: float, use_iter: int) -> dict:
    """The per-cache-depth loss channels: the active depth's channel carries
    this step's l1, the others NaN."""
    out = {}
    for k, s in {0: "no_cache", 1: "cache_1", 2: "cache_2"}.items():
        out[f"l1_loss_{s}"] = l1_value if k == use_iter else float("nan")
    return out


def _zero_tokens(cfg, B: int, device):
    S = 3 * cfg.triplane_resolution ** 2
    tri = torch.zeros(B, cfg.triplane_input_frames, cfg.triplane_feature_dim, S,
                      device=device)
    smpl = torch.zeros(B, cfg.triplane_input_frames, cfg.smpl_token_dim,
                       cfg.smpl_token_len, device=device)
    return tri, smpl


def make_predict_step(model, statics, cfg):
    """(ref_batch, target_batch) -> (rendered, out_tri, out_smpl), without
    autograd and without the cache."""

    @torch.no_grad()
    def step(ref_batch: VideoBatch, target_batch: VideoBatch):
        B = ref_batch.video.shape[0]
        dev = ref_batch.video.device
        tri, smpl = _zero_tokens(cfg, B, dev)
        out = model(statics, ref_batch.video, ref_batch.smpl_parms,
                    ref_batch.cam_parms, target_batch.audio_features,
                    target_batch.cam_parms, cached_triplanes=tri,
                    cached_smpl_tokens=smpl,
                    use_cache=torch.zeros(B, device=dev))
        return out.rendered_images, out.output_triplane_tokens, out.output_smpl_tokens

    return step


class Stage2TrainLoop:
    """Host loop gluing the train step to the prediction cache."""

    def __init__(self, model, statics, cfg, replacement_prob: float = 0.0,
                 seed: int = 0):
        self.step_fn = make_train_step(model, statics, cfg)
        self.cache = PredictionCache(replacement_prob, seed)
        self.cfg = cfg
        self.last_rendered = None
        self.last_ref_rendered = None

    def run_step(self, state: TrainState, ref_batch: VideoBatch,
                 target_batch: VideoBatch, batch_id: int):
        B = ref_batch.video.shape[0]
        dev = ref_batch.video.device
        use, tri, smpl, iters = self.cache.maybe_get(batch_id)
        if use:
            tri, smpl = tri.to(dev), smpl.to(dev)
        else:
            tri, smpl = _zero_tokens(self.cfg, B, dev)
        flag = torch.full((B,), 1.0 if use else 0.0, device=dev)
        state, metrics, out_tri, out_smpl, rendered, ref_rendered = self.step_fn(
            state, ref_batch, target_batch, tri, smpl, flag)
        self.last_rendered = rendered
        self.last_ref_rendered = ref_rendered
        self.cache.put(batch_id, out_tri, out_smpl, iters)
        metrics = dict(metrics)
        metrics["cache_iter"] = float(iters)
        return state, metrics
