"""The reference checkpoint import (`training/torch_import.py`): the JAX
package's import followed by `weights.params_from_flax` against the port's,
on the synthetic Lightning state dicts the JAX tests build.

- Mapping: each oracle goes through both packages' `map_reference_state_dict`
  (or `import_reference_checkpoint` from a saved .ckpt); after
  `params_from_flax` the two state dicts must hold the same keys and the
  same bits, and the reports must be equal.
- Merge: `merge_into` writes the imported tensors into a port model and
  reports the leaves whose shapes differ, on the JAX merge_into's paths.
- Forward: a tiny serving chunk on a random tree overlaid by an import of
  reference-named weights (SMPL-X decoder, audio net, upsampler with folded
  BatchNorms, refiner MLP, heads) against the JAX chunk on the JAX merge
  of the same import, at test_torch_rollout.py's tolerances (tokens and
  SMPL-X params 1e-4, frames mean |diff| <= 1e-3).
- Full width: the checked-in manifest of the released stage-2 .ckpt (649
  tensors), as broadcast zeros, maps onto the port's full stage-2 model
  built on the meta device with no mismatch, with the JAX report.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_motion_avatar_tpu.data.synthetic import make_batch
from audio_motion_avatar_tpu.models.config import AvatarConfig as JaxConfig
from audio_motion_avatar_tpu.ops import smplx as jax_smplx
from audio_motion_avatar_tpu.training import torch_import as jti

from audio_motion_avatar_tpu_torch.models.audio_avatar import AudioDrivenAvatar
from audio_motion_avatar_tpu_torch.models.avatar import TriplaneGaussianAvatar
from audio_motion_avatar_tpu_torch.models.config import AvatarConfig, serving_config
from audio_motion_avatar_tpu_torch.ops import smplx as torch_smplx
from audio_motion_avatar_tpu_torch.serve import build_rollout
from audio_motion_avatar_tpu_torch.training import torch_import as pti
from audio_motion_avatar_tpu_torch.weights import init_weights, params_from_flax
from test_import_upsampler import _randomized_oracle
from test_torch_import import make_ref_state_dict
from test_torch_rollout import OVERRIDES, _perturb
from torch_parity import jax_serving_avatar, one_torch_thread, random_params  # noqa: F401

MANIFEST = os.path.join(os.path.dirname(__file__), "fixtures", "ted_full_ckpt.manifest.json")


def _np(sd):
    return {k: v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in sd.items()}


def upsampler_refiner_sd():
    """test_import_upsampler's full-import oracle: the randomized torch
    upsampler (BatchNorm running stats and affines) and the refiner MLP."""
    m = _randomized_oracle()
    P = "triplane_gaussian"
    sd = {f"{P}.renderer.triplane_upsampler.{k}": v for k, v in m.state_dict().items()}
    torch.manual_seed(3)
    for i in (0, 2, 4):
        o = 3 if i == 4 else 256
        sd[f"{P}.renderer.point_refiner.{i}.weight"] = torch.randn(o, 256)
        sd[f"{P}.renderer.point_refiner.{i}.bias"] = torch.randn(o)
    return _np(sd)


def ptv3_sd():
    """test_torch_import's PTv3 oracle: one encoder block of the reference
    U-Net (attention, MLP, norms) and an unmapped spconv CPE."""
    g = torch.Generator().manual_seed(4)
    C = JaxConfig.tiny().ptv3_enc_channels[0]
    bp = "triplane_gaussian.renderer.point_encoder.point_transformer.enc.enc0.block0"
    shapes = {"norm1.0.weight": (C,), "norm1.0.bias": (C,), "attn.qkv.weight": (3 * C, C),
              "attn.qkv.bias": (3 * C,), "attn.proj.weight": (C, C), "attn.proj.bias": (C,),
              "mlp.fc1.weight": (4 * C, C), "mlp.fc1.bias": (4 * C,),
              "mlp.fc2.weight": (C, 4 * C), "mlp.fc2.bias": (C,), "cpe.0.weight": (27, C, C)}
    return {f"{bp}.{k}": torch.randn(s, generator=g).numpy() for k, s in shapes.items()}


def stage2_sd():
    """test_torch_import's stage-2 oracle (the audio net's reducers and the
    transformer's outer layers) with one transformer block added."""
    import torch.nn as tnn
    torch.manual_seed(3)
    C = 16
    mods = {"audio_triplane.triplane_motion_encoder.conv_time":
            tnn.Conv3d(3 * C, 3 * C, (2, 1, 1), groups=3 * C, bias=False),
            "audio_triplane.smplx_motion_encoder.self_attn":
            tnn.MultiheadAttention(C, 8, batch_first=True),
            "audio_triplane.smplx_motion_encoder.norm1": tnn.LayerNorm(C),
            "audio_triplane.smplx_motion_encoder.norm2": tnn.LayerNorm(C),
            "audio_triplane.smplx_motion_encoder.mlp":
            tnn.Sequential(tnn.Linear(C, 2 * C), tnn.ReLU(), tnn.Linear(2 * C, C))}
    t = "audio_triplane.transformer"
    b = f"{t}.transformer_blocks.0"
    mods.update({f"{t}.norm": tnn.GroupNorm(4, C), f"{t}.proj_in": tnn.Linear(C, 16),
                 f"{t}.proj_out": tnn.Linear(16, C), f"{b}.norm1": tnn.LayerNorm(16),
                 f"{b}.attn1.to_q": tnn.Linear(16, 16, bias=False),
                 f"{b}.attn1.to_k": tnn.Linear(16, 16, bias=False),
                 f"{b}.attn1.to_v": tnn.Linear(16, 16, bias=False),
                 f"{b}.attn1.to_out.0": tnn.Linear(16, 16),
                 f"{b}.ff.net.0.proj": tnn.Linear(16, 128), f"{b}.ff.net.2": tnn.Linear(64, 16)})
    return {f"{p}.{k}": v.detach().numpy() for p, m in mods.items()
            for k, v in m.state_dict().items()}


ORACLES = {"stage-1 names": (lambda tmp: _np(make_ref_state_dict(tmp)[1]), 1),
           "upsampler and refiner": (lambda tmp: upsampler_refiner_sd(), 1),
           "PTv3 block": (lambda tmp: ptv3_sd(), 1),
           "stage 2": (lambda tmp: stage2_sd(), 2)}


def _same_state_dicts(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", list(ORACLES))
def test_import_is_the_jax_import_then_params_from_flax(name, tmp_path):
    make, stage = ORACLES[name]
    sd = make(tmp_path)
    jp, jrep = jti.map_reference_state_dict(sd, JaxConfig.tiny(), stage=stage)
    pp, prep = pti.map_reference_state_dict(sd, AvatarConfig.tiny(), stage=stage)
    assert prep == jrep
    assert prep["loaded"] > 0
    _same_state_dicts(params_from_flax(pp), params_from_flax(jp))


def test_import_reads_a_lightning_file(tmp_path):
    """import_reference_checkpoint on a saved Lightning envelope (epoch,
    global_step, plain-dict hyper_parameters, state_dict), against the JAX
    import of the same file."""
    _, sd = make_ref_state_dict(tmp_path)
    path = str(tmp_path / "lightning.ckpt")
    torch.save({"epoch": 3, "global_step": 120, "hyper_parameters": {"lr": 1e-4},
                "state_dict": sd}, path)
    jp, jrep = jti.import_reference_checkpoint(path, JaxConfig.tiny())
    pp, prep = pti.import_reference_checkpoint(path, AvatarConfig.tiny())
    assert prep == jrep and "triplane_gaussian.sapiens_encoder.model.blocks.0" not in \
        prep["skipped_modules"]
    _same_state_dicts(params_from_flax(pp), params_from_flax(jp))


def test_import_refuses_what_weights_only_cannot_read(tmp_path):
    """The port reads with weights_only=True: a file pickling an object
    raises, naming it; a file that is no checkpoint raises clearly; a
    missing file raises FileNotFoundError, naming the path."""
    path = str(tmp_path / "objects.ckpt")
    torch.save({"state_dict": {}, "hyper_parameters": torch.nn.Identity()}, path)
    with pytest.raises(ValueError, match="weights_only=True.*Identity"):
        pti.import_reference_checkpoint(path, AvatarConfig.tiny())
    with pytest.raises(ValueError, match="not a torch checkpoint"):
        pti.import_reference_checkpoint(__file__, AvatarConfig.tiny())
    with pytest.raises(FileNotFoundError, match="missing.ckpt"):
        pti.import_reference_checkpoint(str(tmp_path / "missing.ckpt"), AvatarConfig.tiny())


def test_merge_into_writes_fp32_and_reports_shapes():
    """The upsampler oracle (C = 8) into the tiny stage-1 model (32
    channels): the refiner MLP (256 wide on both) is written as fp32, each
    upsampler leaf is reported on its flax path with both shapes and left
    as it was; a stage-2 tree's leaves are not in a stage-1 model; the
    PTv3 block lands in the port's refiner."""
    cfg = AvatarConfig.tiny()
    model = TriplaneGaussianAvatar(cfg, 300 + 578)
    init_weights(model, 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sd = upsampler_refiner_sd()
    partial, _ = pti.map_reference_state_dict(sd, cfg)
    mism = pti.merge_into(model, partial)
    assert len(mism) == 12 and all(m.startswith("/renderer/upsampler/") for m in mism)
    assert "/renderer/upsampler/up_0/conv_kernel: model (32, 32, 3, 3) vs ckpt (8, 8, 3, 3)" in mism
    after = model.state_dict()
    assert all(torch.equal(after[k], before[k]) for k in after if "upsampler" in k)
    for i in (0, 2, 4):
        got = after[f"renderer.refine_mlp.{i}.weight"]
        assert got.dtype == torch.float32
        assert torch.equal(got, torch.from_numpy(sd[f"triplane_gaussian.renderer.point_refiner.{i}.weight"]))

    partial, _ = pti.map_reference_state_dict(stage2_sd(), cfg, stage=2)
    mism = pti.merge_into(model, partial)
    assert mism and all(m.startswith("/audio_triplane/") and m.endswith(": not in model")
                        for m in mism)

    blocks = ptv3_sd()
    partial, _ = pti.map_reference_state_dict(blocks, cfg)
    assert pti.merge_into(model, partial) == []
    bp = "triplane_gaussian.renderer.point_encoder.point_transformer.enc.enc0.block0"
    got = model.state_dict()["renderer.point_refiner.unet.enc0_b0.mlp1.weight"]
    assert torch.equal(got, torch.from_numpy(blocks[f"{bp}.mlp.fc1.weight"]))


def _dense(p):
    out = {"weight": np.asarray(p["kernel"]).T}
    if "bias" in p:
        out["bias"] = np.asarray(p["bias"])
    return out


def reference_state_dict(params, rng):
    """The reference-named (Lightning) state dict holding the values of a
    JAX serving tree's SMPL-X decoder, audio net, upsampler, refiner MLP
    and heads: the inverse of the import's mappers, with random BatchNorm
    running statistics and affines in the upsampler's norm slots."""
    sd = {}

    def put(prefix, d):
        sd.update({f"{prefix}.{k}": np.ascontiguousarray(v, np.float32) for k, v in d.items()})

    tg, at = params["triplane_gaussian"], params["audio_triplane"]
    dec = tg["smplx_triplane_encoder"]["smpl_decoder"]
    heads = {v: k for k, v in {
        "dec_body_root_pose": "body_root_pose", "dec_body_pose": "body_pose",
        "dec_body_shape": "body_shape", "dec_transl": "transl", "dec_hand_pose": "hand_pose",
        "dec_face_expression": "face_expression", "dec_face_jaw_pose": "face_jaw_pose",
        "dec_leye_pose": "leye_pose", "dec_reye_pose": "reye_pose"}.items()}
    for name, p in dec.items():
        src = f"mlp.{2 * (int(name[-1]) - 1)}" if name.startswith("mlp") else heads[name]
        put(f"triplane_gaussian.smplx_decoder.{src}", _dense(p))
    sd["triplane_gaussian.smplx_triplane_encoder.smpl_tokens"] = \
        np.asarray(tg["smplx_triplane_encoder"]["smpl_tokens"])
    r = tg["renderer"]
    for name in ("xyz_layer", "rotation_layer", "scaling_layer", "opacity_layer", "shs_layer"):
        put(f"triplane_gaussian.renderer.gaussian_decoder.{name}", _dense(r[name]))
    for layer, p in r["refine_mlp"].items():
        put(f"triplane_gaussian.renderer.point_refiner.{layer[len('layers_'):]}", _dense(p))
    U = "triplane_gaussian.renderer.triplane_upsampler"

    def conv(p):
        return {"weight": np.asarray(p["kernel"]).transpose(3, 2, 0, 1), "bias": p["bias"]}

    for blk, p in r["upsampler"].items():
        if blk == "skip_proj":
            put(f"{U}.skip_connections.0.0", conv(p))
            continue
        bp = f"{U}.upsample_blocks.{blk[len('up_'):]}.upsample"
        put(f"{bp}.1", conv({"kernel": p["conv_kernel"], "bias": p["conv_bias"]}))
        for name, q in p["res"].items():
            src = {"norm1": "3.block.0", "norm2": "3.block.3", "conv1": "3.block.2",
                   "conv2": "3.block.5", "skip": "3.skip"}[name]
            if name.startswith("norm"):
                c = np.shape(q["scale"])[0]
                put(f"{bp}.{src}", {"weight": 1.0 + 0.2 * rng.randn(c),
                                    "bias": 0.1 * rng.randn(c),
                                    "running_mean": 0.3 * rng.randn(c),
                                    "running_var": 0.5 + rng.rand(c)})
            else:
                put(f"{bp}.{src}", conv(q))
    A = "audio_triplane"
    T, C, Tt = np.shape(at["triplane_motion_encoder"]["time_kernel"])
    sd[f"{A}.triplane_motion_encoder.conv_time.weight"] = np.asarray(
        at["triplane_motion_encoder"]["time_kernel"]).reshape(T * C, 1, Tt, 1, 1)
    sm, s = at["smplx_motion_encoder"], f"{A}.smplx_motion_encoder"
    att = sm["self_attn"]
    E = np.shape(att["query"]["kernel"])[0]
    put(f"{s}.self_attn", {
        "in_proj_weight": np.concatenate([np.asarray(att[n]["kernel"]).reshape(E, E).T
                                          for n in ("query", "key", "value")]),
        "in_proj_bias": np.concatenate([np.asarray(att[n]["bias"]).reshape(E)
                                        for n in ("query", "key", "value")]),
        "out_proj.weight": np.asarray(att["out"]["kernel"]).reshape(E, E).T,
        "out_proj.bias": att["out"]["bias"]})
    for n in ("norm1", "norm2"):
        put(f"{s}.{n}", {"weight": sm[n]["scale"], "bias": sm[n]["bias"]})
    put(f"{s}.mlp.0", _dense(sm["mlp1"]))
    put(f"{s}.mlp.2", _dense(sm["mlp2"]))
    tr, t = at["transformer"], f"{A}.transformer"
    put(f"{t}.norm", {"weight": tr["norm"]["scale"], "bias": tr["norm"]["bias"]})
    put(f"{t}.proj_in", _dense(tr["proj_in"]))
    put(f"{t}.proj_out", _dense(tr["proj_out"]))
    for blk, p in tr.items():
        if not blk.startswith("block_"):
            continue
        bp = f"{t}.transformer_blocks.{blk[len('block_'):]}"
        for n in ("norm1", "norm2", "norm3"):
            put(f"{bp}.{n}", {"weight": p[n]["scale"], "bias": p[n]["bias"]})
        for a in ("attn1", "attn2"):
            for src, dst in (("to_q", "q"), ("to_k", "k"), ("to_v", "v"), ("to_out.0", "out")):
                put(f"{bp}.{a}.{src}", _dense(p[a][dst]))
        put(f"{bp}.ff.net.0.proj", _dense(p["ff"]["wi"]))
        put(f"{bp}.ff.net.2", _dense(p["ff"]["wo"]))
    return sd


def test_forward_on_imported_weights_matches_jax():
    B = 2
    cfg, model, chunk = jax_serving_avatar(
        jax_smplx.synthetic_model(seed=0, num_verts=300), **OVERRIDES)
    T_in, T_out = cfg.triplane_input_frames, cfg.triplane_output_frames
    C, L = cfg.triplane_feature_dim, cfg.smpl_token_len
    rng = np.random.RandomState(0)
    tri = rng.randn(B, T_in, C, 3 * cfg.triplane_resolution ** 2).astype(np.float32) * 0.1
    smpl = rng.randn(B, T_in, C, L).astype(np.float32) * 0.1
    audio = rng.randn(B, T_out, cfg.audio_feature_dim).astype(np.float32) * 0.1
    cams = make_batch(B, T_out, cfg.image_size, seed=3).cam_parms
    jcam = {k: jnp.asarray(v) for k, v in cams.items()}

    base = _perturb(random_params(model, 7, tri, smpl, audio, jcam,
                                  method=lambda m, *a: chunk(m, *a, render=False)),
                    np.random.RandomState(8))
    noise = np.random.RandomState(11)
    other = jax.tree_util.tree_map(
        lambda a: (a + 0.02 * noise.randn(*np.shape(a))).astype(np.float32), base)
    sd = reference_state_dict(other, np.random.RandomState(5))
    jpart, jrep = jti.map_reference_state_dict(sd, cfg, stage=2)
    merged, jmism = jti.merge_into(base, jpart)
    assert jmism == [] and jrep["skipped_modules"] == []

    pcfg = serving_config(AvatarConfig.tiny(image_size=(32, 32)), **OVERRIDES)
    port = build_rollout(pcfg, device="cpu",
                         smplx_model=torch_smplx.synthetic_model(seed=0, num_verts=300),
                         state_dict=params_from_flax(base))
    ppart, prep = pti.map_reference_state_dict(sd, pcfg, stage=2)
    assert prep == jrep and pti.merge_into(port.model, ppart) == []
    got = port.model.state_dict()
    for k, v in params_from_flax(merged).items():
        assert torch.equal(got[k], v), k

    r, ot, os_, pred = jax.jit(lambda p, *a: model.apply({"params": p}, *a, method=chunk))(
        merged, tri, smpl, audio, jcam)
    with torch.no_grad():
        pr, pot, pos, ppred = port.model.rollout(port.statics, torch.as_tensor(tri),
                                                 torch.as_tensor(smpl), torch.as_tensor(audio),
                                                 {k: torch.as_tensor(v) for k, v in cams.items()})
    np.testing.assert_allclose(pot.numpy(), np.asarray(ot), atol=1e-4, rtol=0)
    np.testing.assert_allclose(pos.numpy(), np.asarray(os_), atol=1e-4, rtol=0)
    for k in pred:
        np.testing.assert_allclose(ppred[k].numpy(), np.asarray(pred[k]), atol=1e-4, rtol=0,
                                   err_msg=k)
    frames = np.asarray(r)
    assert np.abs(pr.numpy() - frames).mean() <= 1e-3
    assert frames.std() > 1e-2      # not a blank frame


def test_full_width_manifest_maps_onto_the_port_model():
    """The released stage-2 .ckpt's 649 tensors as broadcast zeros (no
    memory), at full width: the port's report equals the JAX one, and the
    import lands on the port's AudioDrivenAvatar (the real SMPL-X topology:
    10475 vertices + 20908 faces) with no mismatch."""
    with open(MANIFEST) as f:
        manifest = json.load(f)
    zero = np.zeros((), np.float32)
    sd = {k: np.broadcast_to(zero, tuple(s)) for k, s in manifest.items()}
    assert len(sd) == 649
    _, jrep = jti.map_reference_state_dict(sd, JaxConfig(), stage=2)
    partial, prep = pti.map_reference_state_dict(sd, AvatarConfig(), stage=2)
    assert prep == jrep and prep["loaded"] == 330
    with torch.device("meta"):
        model = AudioDrivenAvatar(AvatarConfig(), 10475 + 20908)
    assert pti.merge_into(model, partial) == []
