"""Wav2Vec2 encoder of the `wav2vec2-base-960h` architecture (the JAX
package's models/wav2vec2.py), with the reader of a local checkout.

The base variant (do_stable_layer_norm=False):
  * group-norm feature extractor: 7 conv1d stages (k = 10,3,3,3,3,2,2,
    s = 5,2,2,2,2,2,2, no bias), GroupNorm (+GELU) after stage 0 only,
    GELU after the others;
  * feature projection: LayerNorm, then Linear 512 -> 768;
  * grouped positional conv (k = 128, 16 groups; weight-normed in the
    checkout, materialized by `pos_conv_weight`), the trailing element
    trimmed for an even k, GELU, added;
  * LayerNorm, then 12 post-norm layers (x = LN(x + attn(x)); x =
    LN(x + FF(x))), exact (erf) GELU everywhere.

The attention is plain fp32 torch (einsum, softmax), as the JAX package's
is (outside any kernel). The modules carry Hugging Face's parameter names,
so a checkout's state dict loads by name: `load_wav2vec2` reads
`pytorch_model.bin` with torch.load(weights_only=True) or
`model.safetensors` by its own layout (an 8-byte little-endian header
length, a JSON header, then the raw tensors), with neither `transformers`
nor `safetensors` installed.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class Wav2Vec2ArchConfig:
    """The architecture fields this implementation reads (defaults:
    facebook/wav2vec2-base-960h)."""

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_json(cls, path: str) -> "Wav2Vec2ArchConfig":
        with open(path) as f:
            d = json.load(f)
        if d.get("do_stable_layer_norm", False):
            raise ValueError(
                "This implementation covers the do_stable_layer_norm=False "
                "(base) variant; got a stable-layer-norm config.")
        if d.get("feat_extract_norm", "group") != "group":
            raise ValueError("Only feat_extract_norm='group' is supported.")
        keep = {f: d[f] for f in (
            "hidden_size", "num_hidden_layers", "num_attention_heads",
            "intermediate_size", "conv_bias", "num_conv_pos_embeddings",
            "num_conv_pos_embedding_groups", "layer_norm_eps") if f in d}
        for f in ("conv_dim", "conv_kernel", "conv_stride"):
            if f in d:
                keep[f] = tuple(d[f])
        return cls(**keep)


def _gelu(x):
    return F.gelu(x, approximate="none")


class _ConvLayer(nn.Module):
    def __init__(self, c_in, c_out, k, s, bias, norm):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, k, stride=s, bias=bias)
        # torch GroupNorm(C, C): per-channel normalization over time
        self.layer_norm = nn.GroupNorm(c_out, c_out, eps=1e-5) if norm else None

    def forward(self, x):
        x = self.conv(x)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return _gelu(x)


class _FeatureEncoder(nn.Module):
    def __init__(self, c: Wav2Vec2ArchConfig):
        super().__init__()
        chans = (1,) + tuple(c.conv_dim)
        self.conv_layers = nn.ModuleList(
            _ConvLayer(chans[i], chans[i + 1], k, s, c.conv_bias, norm=i == 0)
            for i, (k, s) in enumerate(zip(c.conv_kernel, c.conv_stride)))

    def forward(self, wav):
        x = wav[:, None]                                  # (B, 1, T)
        for layer in self.conv_layers:
            x = layer(x)
        return x.transpose(1, 2)                          # (B, T', C)


class _FeatureProjection(nn.Module):
    def __init__(self, c: Wav2Vec2ArchConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(c.conv_dim[-1], eps=c.layer_norm_eps)
        self.projection = nn.Linear(c.conv_dim[-1], c.hidden_size)

    def forward(self, x):
        return self.projection(self.layer_norm(x))


class _PositionalConv(nn.Module):
    def __init__(self, c: Wav2Vec2ArchConfig):
        super().__init__()
        K = c.num_conv_pos_embeddings
        self.conv = nn.Conv1d(c.hidden_size, c.hidden_size, K, padding=K // 2,
                              groups=c.num_conv_pos_embedding_groups)
        self.trim = K % 2 == 0     # the reference's SamePadLayer

    def forward(self, x):
        pos = self.conv(x.transpose(1, 2))
        if self.trim:
            pos = pos[..., :-1]
        return _gelu(pos).transpose(1, 2)


class _Attention(nn.Module):
    def __init__(self, c: Wav2Vec2ArchConfig):
        super().__init__()
        self.heads = c.num_attention_heads
        self.head_dim = c.hidden_size // c.num_attention_heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, nn.Linear(c.hidden_size, c.hidden_size))

    def forward(self, x):
        B, T, C = x.shape

        def heads(proj):
            return proj(x).reshape(B, T, self.heads, self.head_dim)

        q = heads(self.q_proj) * (self.head_dim ** -0.5)
        k, v = heads(self.k_proj), heads(self.v_proj)
        probs = torch.softmax(torch.einsum("bthd,bshd->bhts", q, k), dim=-1)
        attn = torch.einsum("bhts,bshd->bthd", probs, v)
        return self.out_proj(attn.reshape(B, T, C))


class _FeedForward(nn.Module):
    def __init__(self, c: Wav2Vec2ArchConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(c.hidden_size, c.intermediate_size)
        self.output_dense = nn.Linear(c.intermediate_size, c.hidden_size)

    def forward(self, x):
        return self.output_dense(_gelu(self.intermediate_dense(x)))


class _EncoderLayer(nn.Module):
    """One post-norm layer: x = LN(x + attn(x)); x = finalLN(x + FF(x))."""

    def __init__(self, c: Wav2Vec2ArchConfig):
        super().__init__()
        self.attention = _Attention(c)
        self.layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.feed_forward = _FeedForward(c)
        self.final_layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, x):
        x = self.layer_norm(x + self.attention(x))
        return self.final_layer_norm(x + self.feed_forward(x))


class _Encoder(nn.Module):
    def __init__(self, c: Wav2Vec2ArchConfig):
        super().__init__()
        self.pos_conv_embed = _PositionalConv(c)
        self.layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.layers = nn.ModuleList(_EncoderLayer(c) for _ in range(c.num_hidden_layers))

    def forward(self, x):
        x = self.layer_norm(x + self.pos_conv_embed(x))
        for layer in self.layers:
            x = layer(x)
        return x


class Wav2Vec2Base(nn.Module):
    """waveform (B, T_samples) float32 -> last hidden states (B, T_enc, H)."""

    def __init__(self, cfg: Wav2Vec2ArchConfig = Wav2Vec2ArchConfig()):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = _FeatureEncoder(cfg)
        self.feature_projection = _FeatureProjection(cfg)
        self.encoder = _Encoder(cfg)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = self.feature_projection(self.feature_extractor(wav))
        return self.encoder(x)


def pos_conv_weight(sd: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The weight-normed positional conv's kernel, materialized: a checkout
    stores (g, v) with the norm over dims (0, 1) for each kernel position
    (weight_norm dim=2), as parametrizations.weight.original0 / 1 (newer
    torch) or weight_g / weight_v; w[:, :, i] = g[i] v[:, :, i] /
    ||v[:, :, i]||."""
    base = "encoder.pos_conv_embed.conv."
    if base + "parametrizations.weight.original0" in sd:
        g = sd[base + "parametrizations.weight.original0"]
        v = sd[base + "parametrizations.weight.original1"]
    elif base + "weight_g" in sd:
        g, v = sd[base + "weight_g"], sd[base + "weight_v"]
    else:   # already materialized
        return sd[base + "weight"].float()
    g, v = g.float(), v.float()
    norm = torch.sqrt((v ** 2).sum(dim=(0, 1), keepdim=True))
    return g * v / torch.clamp(norm, min=1e-12)


# checkout keys the encoder does not read (the training-time mask embedding)
_UNUSED = ("masked_spec_embed",)


def state_dict_from_checkout(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A checkout's state dict (a Wav2Vec2Model's, or a task model's with
    the encoder under `wav2vec2.`) -> the state dict of Wav2Vec2Base: the
    encoder's keys, the positional conv's weight norm materialized."""
    if any(k.startswith("wav2vec2.") for k in sd):
        sd = {k[len("wav2vec2."):]: v for k, v in sd.items() if k.startswith("wav2vec2.")}
    base = "encoder.pos_conv_embed.conv."
    out = {k: v.float() for k, v in sd.items()
           if k not in _UNUSED and not (k.startswith(base) and k != base + "bias")}
    out[base + "weight"] = pos_conv_weight(sd)
    return out


_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A `.safetensors` file -> {name: CPU tensor}: an 8-byte little-endian
    header length, the JSON header (name -> dtype, shape, data_offsets
    relative to the end of the header), then the raw little-endian bytes."""
    with open(path, "rb") as f:
        blob = f.read()
    n = int.from_bytes(blob[:8], "little")
    header = json.loads(blob[8:8 + n].decode("utf-8"))
    data = memoryview(blob)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if end == begin:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        t = torch.frombuffer(bytearray(data[begin:end]), dtype=dtype)
        out[name] = t.reshape(shape)
    return out


def read_checkout_weights(model_path: str) -> Dict[str, torch.Tensor]:
    """The weights of a local checkout: model.safetensors or
    pytorch_model.bin."""
    st = os.path.join(model_path, "model.safetensors")
    bin_ = os.path.join(model_path, "pytorch_model.bin")
    if os.path.exists(st):
        return read_safetensors(st)
    if os.path.exists(bin_):
        return torch.load(bin_, map_location="cpu", weights_only=True)
    raise FileNotFoundError(
        f"{model_path}: neither model.safetensors nor pytorch_model.bin (a sharded "
        "checkout is not supported)")


def load_wav2vec2(model_path: str, device="cpu"):
    """A local checkout (config.json and its weights) -> (Wav2Vec2Base on
    `device` in eval mode, do_normalize): do_normalize from
    preprocessor_config.json (default True: base-960h's processor applies
    zero_mean_unit_var to each window before the encoder)."""
    cfg = Wav2Vec2ArchConfig.from_json(os.path.join(model_path, "config.json"))
    model = Wav2Vec2Base(cfg)
    model.load_state_dict(state_dict_from_checkout(read_checkout_weights(model_path)),
                          strict=True)
    do_normalize = True
    pre = os.path.join(model_path, "preprocessor_config.json")
    if os.path.exists(pre):
        with open(pre) as f:
            do_normalize = bool(json.load(f).get("do_normalize", True))
    return model.to(device).eval(), do_normalize


def zero_mean_unit_var(wav: np.ndarray) -> np.ndarray:
    """The processor's normalization of one window: (x - mean) /
    sqrt(var + 1e-7)."""
    wav = np.asarray(wav, np.float32)
    return (wav - wav.mean()) / np.sqrt(wav.var() + 1e-7)
