"""Reference PyTorch checkpoint import (the JAX package's
training/torch_import.py, in numpy).

Maps the reference's Lightning state-dict names (`triplane_gaussian.*`,
`audio_triplane.*`) onto the flax parameter tree the JAX package builds,
with the reference's own weight surgery (the Sapiens / image-feature
weights dropped, non-strict); `weights.params_from_flax` then lays that
tree out as the port's state_dict, and `merge_into` writes it into a model.

Conventions (the mappers are the JAX module's, line for line):
  * torch Linear weight (out, in) -> flax Dense kernel (in, out): transpose;
  * torch Conv2d weight (out, in, kh, kw) -> flax Conv (kh, kw, in, out);
  * torch Embedding (num, dim) -> flax Embed embedding (num, dim): direct;
  * LayerNorm / GroupNorm weight / bias -> scale / bias;
  * the upsampler's eval-mode BatchNorms folded into its affine norm
    (run with renderer.upsampler_norm='affine').

The PTv3 U-Net's spconv stem, CPEs and pool / unpool projections have no
counterpart in the redesigned refiner and stay unmapped; the report lists
what was loaded and skipped.

The checkpoint is read with torch.load(weights_only=True): tensors and
plain containers. A Lightning file whose hyper_parameters pickle other
objects (OmegaConf's, say) loads in the JAX package, which reads with
weights_only=False, and not here: load_torch_state_dict says what it could
not read.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..weights import flax_entries
from .checkpoints import load_torch_state_dict


def _t(w):
    return np.asarray(w).T


def _linear(dst: dict, prefix_t: str, sd: dict, loaded: list):
    """torch Linear at prefix -> flax Dense dict {'kernel','bias'}."""
    w = sd.get(prefix_t + ".weight")
    if w is None:
        return None
    out = {"kernel": _t(w)}
    b = sd.get(prefix_t + ".bias")
    if b is not None:
        out["bias"] = np.asarray(b)
    loaded.append(prefix_t)
    return out


def map_smplx_decoder(sd: dict, prefix: str, loaded: list) -> dict:
    """Reference SMPLXDecoder (smplx_decoder.py:40-82) -> models/smplx_decoder."""
    heads = {
        "dec_body_root_pose": "body_root_pose",
        "dec_body_pose": "body_pose",
        "dec_body_shape": "body_shape",
        "dec_transl": "transl",
        "dec_hand_pose": "hand_pose",
        "dec_face_expression": "face_expression",
        "dec_face_jaw_pose": "face_jaw_pose",
        "dec_leye_pose": "leye_pose",
        "dec_reye_pose": "reye_pose",
    }
    out = {}
    for i, name in enumerate(["mlp1", "mlp2", "mlp3"]):
        m = _linear(out, f"{prefix}.mlp.{i * 2}", sd, loaded)
        if m:
            out[name] = m
    for src, dst in heads.items():
        m = _linear(out, f"{prefix}.{src}", sd, loaded)
        if m:
            out[dst] = m
    return out


def map_transformer1d(sd: dict, prefix: str, num_layers: int, loaded: list) -> dict:
    """Reference Transformer1D_nn -> models/transformer.Transformer1D."""
    out = {}
    gn_w = sd.get(f"{prefix}.norm.weight")
    if gn_w is not None:
        out["norm"] = {"scale": np.asarray(gn_w),
                       "bias": np.asarray(sd[f"{prefix}.norm.bias"])}
        loaded.append(f"{prefix}.norm")
    for name in ["proj_in", "proj_out"]:
        m = _linear(out, f"{prefix}.{name}", sd, loaded)
        if m:
            out[name] = m
    for i in range(num_layers):
        bp = f"{prefix}.transformer_blocks.{i}"
        blk = {}
        for norm in ["norm1", "norm2", "norm3"]:
            w = sd.get(f"{bp}.{norm}.weight")
            if w is not None:
                blk[norm] = {"scale": np.asarray(w),
                             "bias": np.asarray(sd[f"{bp}.{norm}.bias"])}
                loaded.append(f"{bp}.{norm}")
        for attn in ["attn1", "attn2"]:
            a = {}
            for src, dst in [("to_q", "q"), ("to_k", "k"), ("to_v", "v")]:
                m = _linear(a, f"{bp}.{attn}.{src}", sd, loaded)
                if m:
                    a[dst] = m
            m = _linear(a, f"{bp}.{attn}.to_out.0", sd, loaded)
            if m:
                a["out"] = m
            if a:
                blk[attn] = a
        ff = {}
        m = _linear(ff, f"{bp}.ff.net.0.proj", sd, loaded)  # GEGLU proj
        if m:
            ff["wi"] = m
        m = _linear(ff, f"{bp}.ff.net.2", sd, loaded)
        if m:
            ff["wo"] = m
        if ff:
            blk["ff"] = ff
        if blk:
            out[f"block_{i}"] = blk
    return out


def map_ptv3_block(sd: dict, bp: str, heads: int, loaded: list) -> dict:
    """One reference PTv3 Block (pointtransformer_v3.py:528-615) -> one
    models/ptv3.SerialBlock: the pre-LN attention + MLP weights are
    structurally identical (same residual wiring, same per-head math, exact
    GELU); only the CPE differs (spconv 3^3 submanifold conv vs the
    serialized depthwise xCPE) and stays unmapped.

    Layouts: torch attn.qkv weight (3C, C) splits into thirds (q/k/v), each
    reshaped head-major (C_in, H, D) to match _ProjGHPD — torch computes
    q[h*D+d] from row h*D+d (qkv reshape (..., 3, H, D),
    pointtransformer_v3.py:452-466). attn.proj (C, C) -> out (H, D, C)."""
    blk: dict = {}
    for t_norm, f_norm in [("norm1.0", "ln1"), ("norm2.0", "ln2")]:
        w = sd.get(f"{bp}.{t_norm}.weight")
        if w is not None:
            blk[f_norm] = {"scale": np.asarray(w),
                           "bias": np.asarray(sd[f"{bp}.{t_norm}.bias"])}
            loaded.append(f"{bp}.{t_norm}")
    qkv_w = sd.get(f"{bp}.attn.qkv.weight")
    if qkv_w is not None:
        qkv_w = np.asarray(qkv_w)               # (3C, C)
        C = qkv_w.shape[1]
        H, D = heads, C // heads
        qkv_b = sd.get(f"{bp}.attn.qkv.bias")
        attn: dict = {}
        for t, name in enumerate(["query", "key", "value"]):
            part = {"kernel": qkv_w[t * C:(t + 1) * C].T.reshape(C, H, D)}
            if qkv_b is not None:
                part["bias"] = np.asarray(qkv_b)[t * C:(t + 1) * C] \
                    .reshape(H, D)
            attn[name] = part
        loaded.append(f"{bp}.attn.qkv")
        pw = sd.get(f"{bp}.attn.proj.weight")
        if pw is not None:
            out = {"kernel": np.asarray(pw).T.reshape(H, D, C)}
            pb = sd.get(f"{bp}.attn.proj.bias")
            if pb is not None:
                out["bias"] = np.asarray(pb)
            attn["out"] = out
            loaded.append(f"{bp}.attn.proj")
        blk["attn"] = attn
    for t_fc, f_fc in [("mlp.fc1", "mlp1"), ("mlp.fc2", "mlp2")]:
        m = _linear(blk, f"{bp}.{t_fc}", sd, loaded)
        if m:
            blk[f_fc] = m
    return blk


def map_ptv3(sd: dict, prefix: str, cfg, loaded: list) -> dict:
    """Reference PointTransformerV3 U-Net -> models/ptv3.PTv3Encoder
    ('unet') params: every enc/dec Block's attention + MLP maps 1:1; the
    spconv embedding stem, spconv CPEs, and the pool/unpool projections
    (whose reference forms append BatchNorm1d+GELU absent from the
    TPU redesign) stay unmapped — finetune protocol in PARITY.md.
    `prefix` = '...renderer.point_encoder.point_transformer'."""
    unet: dict = {}
    for s, (depth, heads) in enumerate(zip(cfg.ptv3_enc_depths,
                                           cfg.ptv3_enc_heads)):
        for b in range(depth):
            blk = map_ptv3_block(sd, f"{prefix}.enc.enc{s}.block{b}",
                                 heads, loaded)
            if blk:
                unet[f"enc{s}_b{b}"] = blk
    for d, (depth, heads) in enumerate(zip(cfg.ptv3_dec_depths,
                                           cfg.ptv3_dec_heads)):
        for b in range(depth):
            blk = map_ptv3_block(sd, f"{prefix}.dec.dec{d}.block{b}",
                                 heads, loaded)
            if blk:
                unet[f"dec{d}_b{b}"] = blk
    return {"unet": unet} if unet else {}


def map_gaussian_heads(sd: dict, prefix: str, loaded: list) -> dict:
    out = {}
    for src, dst in [("xyz_layer", "xyz_layer"),
                     ("rotation_layer", "rotation_layer"),
                     ("scaling_layer", "scaling_layer"),
                     ("opacity_layer", "opacity_layer"),
                     ("shs_layer", "shs_layer")]:
        m = _linear(out, f"{prefix}.gaussian_decoder.{src}", sd, loaded)
        if m:
            out[dst] = m
    return out


def _conv2d(sd: dict, prefix: str, loaded: list):
    """torch Conv2d (Co, C, kh, kw) -> flax Conv {kernel (kh, kw, C, Co)}."""
    w = sd.get(prefix + ".weight")
    if w is None:
        return None
    out = {"kernel": np.asarray(w).transpose(2, 3, 1, 0)}
    b = sd.get(prefix + ".bias")
    if b is not None:
        out["bias"] = np.asarray(b)
    loaded.append(prefix)
    return out


def _bn_affine(sd: dict, prefix: str, loaded: list, eps: float = 1e-5):
    """Fold eval-mode BatchNorm2d into the upsampler's 'affine' norm slots:
    y = x * w/sqrt(rv+eps) + (b - rm * w/sqrt(rv+eps)) — exact inference
    BN. Run the imported model with renderer.upsampler_norm='affine'."""
    w = sd.get(prefix + ".weight")
    if w is None:
        return None
    inv = np.asarray(w) / np.sqrt(np.asarray(sd[prefix + ".running_var"]) + eps)
    loaded.append(prefix)
    return {"scale": inv,
            "bias": np.asarray(sd[prefix + ".bias"])
            - np.asarray(sd[prefix + ".running_mean"]) * inv}


def map_upsampler(sd: dict, prefix: str, num_blocks: int, loaded: list) -> dict:
    """Reference TriplaneUpsampler (renderer.py:348-417) -> models/upsampler.

    torch layout per block i: upsample_blocks.{i}.upsample = Sequential(
    Upsample, Conv2d, ReLU, ResBlock) with ResBlock.block = Sequential(BN,
    ReLU, Conv2d, BN, ReLU, Conv2d); skip_connections.0.0 is the one 1x1
    projection (blocks >0 are Identity+Upsample, parameter-free).
    BatchNorms fold to per-channel affines (_bn_affine)."""
    out: dict = {}
    for i in range(num_blocks):
        bp = f"{prefix}.upsample_blocks.{i}.upsample"
        blk: dict = {}
        c = _conv2d(sd, f"{bp}.1", loaded)
        if c:
            blk["conv_kernel"] = c["kernel"]
            blk["conv_bias"] = c["bias"]
        res: dict = {}
        for src, dst in [(f"{bp}.3.block.0", "norm1"),
                         (f"{bp}.3.block.3", "norm2")]:
            n = _bn_affine(sd, src, loaded)
            if n:
                res[dst] = n
        for src, dst in [(f"{bp}.3.block.2", "conv1"),
                         (f"{bp}.3.block.5", "conv2"),
                         (f"{bp}.3.skip", "skip")]:
            c = _conv2d(sd, src, loaded)
            if c:
                res[dst] = c
        if res:
            blk["res"] = res
        if blk:
            out[f"up_{i}"] = blk
    sp = _conv2d(sd, f"{prefix}.skip_connections.0.0", loaded)
    if sp:
        out["skip_proj"] = sp
    return out


def map_resnet_fc(sd: dict, prefix: str, loaded: list) -> dict:
    out = {}
    for src, dst in [("fc_0", "fc_0"), ("fc_1", "fc_1"), ("shortcut", "shortcut")]:
        m = _linear(out, f"{prefix}.{src}", sd, loaded)
        if m:
            out[dst] = m
    return out


def map_mha(sd: dict, prefix: str, heads: int, loaded: list):
    """torch nn.MultiheadAttention -> flax nn.MultiHeadDotProductAttention.

    torch packs q/k/v into in_proj_weight (3E, E); flax uses DenseGeneral
    kernels (E, H, hd) for q/k/v and (H, hd, E) for out. Both scale by
    1/sqrt(hd), so the split+transpose+reshape is numerically exact.
    """
    w = sd.get(prefix + ".in_proj_weight")
    if w is None:
        return None
    w = np.asarray(w)
    E = w.shape[1]
    hd = E // heads
    b = sd.get(prefix + ".in_proj_bias")
    b = np.zeros(3 * E, np.float32) if b is None else np.asarray(b)

    def proj(wx, bx):
        return {"kernel": wx.T.reshape(E, heads, hd),
                "bias": bx.reshape(heads, hd)}

    ow = np.asarray(sd[prefix + ".out_proj.weight"])  # (E, E)
    ob = np.asarray(sd[prefix + ".out_proj.bias"])
    loaded.append(prefix)
    return {
        "query": proj(w[:E], b[:E]),
        "key": proj(w[E:2 * E], b[E:2 * E]),
        "value": proj(w[2 * E:], b[2 * E:]),
        "out": {"kernel": ow.T.reshape(heads, hd, E), "bias": ob},
    }


def map_audio_triplane(sd: dict, cfg, loaded: list) -> dict:
    """Stage-2 AudioTriplaneNet mapping (reference prefix `audio_triplane.*`,
    main2.py:133-137, triplane_audio_net.py:110-141):
      * conv_time (3C,1,T,1,1) depthwise Conv3d -> time_kernel (3, C, T)
        (both are plane-major over the 3C channel axis);
      * smplx_motion_encoder: torch MultiheadAttention + LayerNorms + MLP;
      * the 8-layer audio cross-attention Transformer1D.
    """
    A = "audio_triplane"
    out: dict = {}
    w = sd.get(f"{A}.triplane_motion_encoder.conv_time.weight")
    if w is not None:
        w = np.asarray(w)  # (3C, 1, T, 1, 1), groups=3C
        c3, _, T = w.shape[:3]
        out["triplane_motion_encoder"] = {
            "time_kernel": w.reshape(3, c3 // 3, T)}
        loaded.append(f"{A}.triplane_motion_encoder.conv_time")
    sm: dict = {}
    s = f"{A}.smplx_motion_encoder"
    m = map_mha(sd, f"{s}.self_attn", 8, loaded)
    if m:
        sm["self_attn"] = m
    for norm in ["norm1", "norm2"]:
        w = sd.get(f"{s}.{norm}.weight")
        if w is not None:
            sm[norm] = {"scale": np.asarray(w),
                        "bias": np.asarray(sd[f"{s}.{norm}.bias"])}
            loaded.append(f"{s}.{norm}")
    m = _linear(sm, f"{s}.mlp.0", sd, loaded)
    if m:
        sm["mlp1"] = m
    m = _linear(sm, f"{s}.mlp.2", sd, loaded)
    if m:
        sm["mlp2"] = m
    if sm:
        out["smplx_motion_encoder"] = sm
    t = map_transformer1d(sd, f"{A}.transformer",
                          cfg.audio_transformer_layers, loaded)
    if t:
        out["transformer"] = t
    return out


def import_reference_checkpoint(path: str, cfg, stage: int = 1) -> Tuple[dict, dict]:
    """Load a reference .ckpt and build a partial flax params tree.

    Returns (partial_params, report). For stage=1, partial_params mirrors the
    TriplaneGaussianAvatar tree; for stage=2 it mirrors AudioDrivenAvatar
    ({"triplane_gaussian": <stage-1 tree>, "audio_triplane": ...}, the
    released full checkpoint layout, reference main2.py:127-138). Merge with
    `merge_into` below.
    """
    return map_reference_state_dict(load_torch_state_dict(path), cfg, stage)


def map_reference_state_dict(sd: dict, cfg, stage: int = 1) -> Tuple[dict, dict]:
    """State-dict-level body of `import_reference_checkpoint`: also callable
    on a SYNTHETIC zeros state dict built from a key/shape manifest
    (tools/manifest.py) to dry-run the mapping without the released asset."""
    loaded: list = []
    P = "triplane_gaussian"
    params: dict = {}

    # SMPLX decoder (shared)
    dec = map_smplx_decoder(sd, f"{P}.smplx_decoder", loaded)
    enc: dict = {}
    if dec:
        enc["smpl_decoder"] = dec

    # triplane encoder pieces
    e = f"{P}.smplx_triplane_encoder"
    m = _linear(enc, f"{e}.fc_pos", sd, loaded)
    if m:
        enc["fc_pos"] = m
    m = _linear(enc, f"{e}.fc_c", sd, loaded)
    if m:
        enc["fc_c"] = m
    for i in range(3):
        blk = map_resnet_fc(sd, f"{e}.blocks.{i}", loaded)
        if blk:
            enc[f"block_{i}"] = blk
    w = sd.get(f"{e}.vertex_emb.weight")
    if w is not None:
        enc["vertex_emb"] = {"embedding": np.asarray(w)}
        loaded.append(f"{e}.vertex_emb")
    if f"{e}.smpl_tokens" in sd:
        enc["smpl_tokens"] = np.asarray(sd[f"{e}.smpl_tokens"])
        loaded.append(f"{e}.smpl_tokens")
    ca = map_transformer1d(sd, f"{e}.cross_attn",
                           cfg.smplx_transformer_layers, loaded)
    if ca:
        enc["smpl_cross_attn"] = ca
    if enc:
        params["smplx_triplane_encoder"] = enc

    # fusion network
    f = f"{P}.fusion_network"
    fus: dict = {}
    w = sd.get(f"{f}.triplane_tokenizer_geometry.embeddings")
    if w is not None:
        fus["triplane_tokenizer"] = {"embeddings": np.asarray(w)}
        loaded.append(f"{f}.triplane_tokenizer_geometry")
    tc = map_transformer1d(sd, f"{f}.transformer_cross",
                           cfg.cross_transformer_layers, loaded)
    if tc:
        fus["transformer_cross"] = tc
    if fus:
        params["fusion_network"] = fus

    # renderer heads + upsampler (BN folded) + point-refiner MLP
    rend = map_gaussian_heads(sd, f"{P}.renderer", loaded)
    ups = map_upsampler(sd, f"{P}.renderer.triplane_upsampler",
                        cfg.num_upsample_blocks, loaded)
    if ups:
        rend["upsampler"] = ups
    refine: dict = {}
    for i in (0, 2, 4):
        m = _linear(refine, f"{P}.renderer.point_refiner.{i}", sd, loaded)
        if m:
            refine[f"layers_{i}"] = m
    if refine:
        rend["refine_mlp"] = refine
    ptv3 = map_ptv3(sd, f"{P}.renderer.point_encoder.point_transformer",
                    cfg, loaded)
    if ptv3:
        rend["point_refiner"] = ptv3
    if rend:
        params["renderer"] = rend

    if stage == 2:
        audio = map_audio_triplane(sd, cfg, loaded)
        params = {"triplane_gaussian": params}
        if audio:
            params["audio_triplane"] = audio

    skipped = sorted(
        {k.rsplit(".", 1)[0] for k in sd
         if not any(k.startswith(p) for p in loaded)
         and "sapiens" not in k and "image_feature" not in k})
    report = {
        "loaded": len(loaded),
        "total_torch_modules": len({k.rsplit('.', 1)[0] for k in sd}),
        "skipped_modules": skipped,
    }
    if ups:
        report.setdefault("notes", []).append(
            "upsampler BatchNorms folded from running stats — run with "
            "model.renderer.upsampler_norm='affine' for exact inference "
            "parity")
    if ptv3:
        report.setdefault("notes", []).append(
            "PTv3 U-Net partially imported: block attention+MLP mapped 1:1; "
            "spconv stem/CPEs and pool/unpool projections need the "
            "finetune protocol in PARITY.md")
    return params, report


def merge_into(model: nn.Module, partial: dict, shard=None) -> list:
    """Overlay an imported flax-layout tree (map_reference_state_dict's) onto
    `model`'s parameters in place, non-strict, checking shapes: each leaf
    goes through weights.params_from_flax's layout rules and is written, as
    fp32, into the model's (fp32 master) parameter of that name. shard: a
    model sharded over a mesh's 'model' axis takes this rank's slice of each
    leaf (TrainState.shard). Returns the
    mismatches, worded as the JAX merge_into's: "<flax path>: not in model"
    or "<flax path>: model <shape> vs ckpt <shape>" (torch layouts)."""
    params = model.state_dict(keep_vars=True)
    mismatches = []
    with torch.no_grad():
        for path, key, value in flax_entries(partial):
            where = "/" + "/".join(path)
            if shard is not None and key in params:
                value = shard({key: value})[key]
            if key not in params:
                mismatches.append(f"{where}: not in model")
            elif tuple(params[key].shape) != tuple(value.shape):
                mismatches.append(f"{where}: model {tuple(params[key].shape)} vs ckpt "
                                  f"{tuple(value.shape)}")
            else:
                params[key].copy_(value)
    return mismatches
