"""The port's `main2 --mode demo` against the JAX package's demo on the CPU.

Weights: the trained tiny fixture (tests/fixtures/demo_tiny_ckpt/320, read
from its orbax directory), made visible as tests/test_torch_reconstruct.py
makes it (opacity and scale head biases raised, the refiner's offsets and
the decoded translations and root rotations damped) and with the audio
transformer's output projection damped x0.01, as chip_smoke.py tames
seeded weights: alone, the fixture renders near-white frames in both
packages, and over three chunks the undamped token updates blank them too.
The frozen ViT is the port's seeded one in both (a checkpoint leaves it
out, so the port's demo keeps its own seeded ViT), and the port's ViT is
fed the JAX ViT's image tokens: the ViT computes in bf16 and rounds
differently in the two packages (held to bf16 noise in
tests/test_torch_reconstruct.py), which the three-chunk rollout would
carry into every later comparison.

The port runs its whole CLI (`main2.main --device cpu --checkpoint DIR`,
the weights saved by its CheckpointManager); the JAX side runs its
main2.run_demo after main2.main's demo preamble (config, build_stage2,
the serving profile) with the same parameters, which skips the flax init
that main2.main would run op by op (~170 s on an 8-core CPU) only to be
overwritten by the restore. Both on config_tiny.yaml with
dataset.render_gt=true and dataset.length=26: 3 chunks, so the token window
slides twice.
"""

import contextlib
import io
import os
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from torch_parity import flax_from_state_dict, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "demo_tiny_ckpt" / "320" / "default"
JAX_CONFIG = ROOT / "audio_motion_avatar_tpu" / "configs" / "config_tiny.yaml"
PORT_CONFIG = ROOT / "audio_motion_avatar_tpu_torch" / "configs" / "config_tiny.yaml"
OVERRIDES = ["dataset.render_gt=true", "dataset.length=26"]
VIT = "triplane_gaussian.sapiens_encoder"
LINE = re.compile(r"\[demo\] chunk (\d+) (even|odd): L1=([-\d.]+) SMPLX=([-\d.]+)")


def _visible(params):
    """The fixture's trained params made visible (see the docstring)."""
    rd = params["triplane_gaussian"]["renderer"]
    rd["opacity_layer"]["bias"] += 4.0
    rd["scaling_layer"]["bias"] += 2.0
    rd["refine_mlp"]["layers_4"]["kernel"] *= 0.01
    rd["refine_mlp"]["layers_4"]["bias"] *= 0.0
    dec = params["triplane_gaussian"]["smplx_triplane_encoder"]["smpl_decoder"]
    dec["transl"]["kernel"] *= 0.01
    dec["transl"]["bias"] *= 0.0
    dec["body_root_pose"]["kernel"] *= 0.01
    dec["body_root_pose"]["bias"] = np.array([1, 0, 0, 0, 1, 0], np.float32)
    params["audio_triplane"]["transformer"]["proj_out"]["kernel"] *= 0.01
    return params


def _read_frames(d):
    from PIL import Image
    names = sorted(os.listdir(d))
    return names, np.stack([np.asarray(Image.open(os.path.join(d, n)).convert("RGB"),
                                       np.float32) / 255.0 for n in names])


def _mp4_frames(path):
    import cv2
    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def _run(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


@pytest.fixture(scope="module")
def demos(tmp_path_factory):
    import orbax.checkpoint as ocp
    from audio_motion_avatar_tpu import main2 as jmain2
    from audio_motion_avatar_tpu.configs import ConfigLoader as JaxLoader
    from audio_motion_avatar_tpu.configs.build import apply_serving_profile as jax_serving
    from audio_motion_avatar_tpu.data.factory import DatasetFactory as JaxFactory
    from audio_motion_avatar_tpu.models.audio_avatar import AudioDrivenAvatar as JaxAvatar
    from audio_motion_avatar_tpu_torch import main2
    from audio_motion_avatar_tpu_torch.configs import ConfigLoader
    from audio_motion_avatar_tpu_torch.configs.build import (apply_serving_profile,
                                                             build_avatar_config)
    from audio_motion_avatar_tpu_torch.models import image_encoder
    from audio_motion_avatar_tpu_torch.training.checkpoints import CheckpointManager
    from audio_motion_avatar_tpu_torch.weights import params_from_flax

    tmp = tmp_path_factory.mktemp("demo")
    raw = ocp.StandardCheckpointer().restore(str(FIXTURE))
    params = _visible(jax.tree_util.tree_map(np.array, raw["params"]))

    # the port's model as its demo builds it, seeded: its ViT goes into the
    # JAX tree, the rest of the JAX tree into its checkpoint
    cfg = ConfigLoader.load_config(str(PORT_CONFIG), OVERRIDES)
    ac = apply_serving_profile(build_avatar_config(cfg), cfg)
    rollout = main2.build_stage2(cfg, ac, "cpu")
    seeded = rollout.model.state_dict()
    tg = params["triplane_gaussian"]
    tg["sapiens_encoder"] = flax_from_state_dict(tg["sapiens_encoder"], seeded, VIT)
    rollout.model.load_state_dict(params_from_flax(params), strict=True)
    ckpt = tmp / "port_ckpt"
    CheckpointManager(str(ckpt)).save(320, main2.init_state2(rollout.model, cfg))

    # JAX: main2.main's demo preamble, then its run_demo on these params
    jout = tmp / "jax"
    jcfg = JaxLoader.load_config(str(JAX_CONFIG),
                                 OVERRIDES + [f"training.output_dir={jout}"])
    model, statics, jac = jmain2.build_stage2(jcfg)
    jac = jax_serving(jac, jcfg)
    model = JaxAvatar(cfg=jac, num_verts_encoder=model.num_verts_encoder,
                      point_refiner=model.point_refiner)
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, params)
    _, jax_log = _run(lambda: jmain2.run_demo(jcfg, model, statics, jac,
                                              SimpleNamespace(params=jparams), None, None))

    # the JAX ViT's image tokens of the demo's reference batch (streams A, B)
    ds = JaxFactory.create_dataset(jcfg, split="val")
    video = np.concatenate([ds[0][0].video, ds[1][0].video], 0)
    vit = jax.jit(lambda p, v: model.apply(
        {"params": p}, v, method=lambda m, v: m.triplane_gaussian.sapiens_encoder(
            v.reshape((-1,) + v.shape[2:]))))
    tokens = torch.as_tensor(np.array(vit(jparams, video)))

    def port(out, *extra):
        argv = ["--device", "cpu", "--config", str(PORT_CONFIG), "--mode", "demo",
                "--checkpoint", str(ckpt), f"training.output_dir={out}", *OVERRIDES, *extra]
        return _run(lambda: main2.main(argv))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(image_encoder.SapiensEncoder, "forward", lambda self, images: tokens)
        (summary, port_log) = port(tmp / "port")
        (fused, fused_log) = port(tmp / "fused", "model.demo_fuse_chunks=2")
    return SimpleNamespace(jax_dir=jout / "demo_outputs", jax_log=jax_log,
                           port_dir=tmp / "port" / "demo_outputs", port_log=port_log,
                           summary=summary, fused_dir=tmp / "fused" / "demo_outputs",
                           fused=fused, fused_log=fused_log)


def test_frames_match_jax(demos):
    """Same names and order; each decoded frame within mean |diff| 1e-3 of
    JAX's; most frames not blank."""
    names, got = _read_frames(demos.port_dir / "frames")
    want_names, want = _read_frames(demos.jax_dir / "frames")
    assert names == want_names and len(names) == 36
    assert got.shape == want.shape
    mad = np.abs(got - want).reshape(len(names), -1).mean(1)
    assert (mad <= 1e-3).all(), mad
    live = (got.reshape(len(names), -1).std(1) > 0.01) & \
        ((got < 0.999).reshape(len(names), -1).mean(1) > 0.01)
    assert live.mean() > 0.5, live


def test_overlay_video_frame_count(demos):
    """Both packages draw the SMPL-X overlay on every frame and write it
    only into smplx_sequence.mp4."""
    assert demos.summary["overlays"] == demos.summary["frames"] == 36
    for d in (demos.port_dir, demos.jax_dir):
        assert _mp4_frames(d / "smplx_sequence.mp4") == 36
        assert _mp4_frames(d / "original_sequence.mp4") == 36


def test_printed_losses_match_jax(demos):
    """Every printed L1 within 1e-3 of JAX's, every SMPL-X loss within 1e-4."""
    got, want = LINE.findall(demos.port_log), LINE.findall(demos.jax_log)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        assert abs(float(g[2]) - float(w[2])) <= 1e-3, (g, w)
        assert abs(float(g[3]) - float(w[3])) <= 1e-4, (g, w)
    assert [(str(c), n) for c, n, _, _ in demos.summary["losses"]] == [g[:2] for g in got]


def test_fused_chunks_bit_equal(demos):
    """demo_fuse_chunks=2 (one fused group of two chunks, then the third
    alone) writes the unfused run's frames bit for bit and prints the same
    losses."""
    names, got = _read_frames(demos.fused_dir / "frames")
    want_names, want = _read_frames(demos.port_dir / "frames")
    assert names == want_names
    np.testing.assert_array_equal(got, want)
    assert LINE.findall(demos.fused_log) == LINE.findall(demos.port_log)
    assert len(demos.fused["chunk_seconds"]) == 2


def test_summary_times_every_part(demos):
    s = demos.summary
    assert s["n_chunks"] == 3 and len(s["chunk_seconds"]) == 3
    assert set(s["seconds"]) == {"build", "data", "audio features", "stage-1 tokens",
                                 "rollouts", "losses", "overlays", "writing"}
    assert s["mp4"]["original"].endswith("original_sequence.mp4")


def _cli(*extra):
    return ["--device", "cpu", "--config", str(PORT_CONFIG), *extra]


@pytest.mark.parametrize("argv,error,match", [
    (["--mode", "test", "--checkpoint", __file__], ValueError, "not a torch checkpoint"),
    (["--mode", "demo", "--checkpoint", __file__], ValueError, "not a torch checkpoint"),
])
def test_main2_refusals_name_the_roadmap_item(argv, error, match):
    from audio_motion_avatar_tpu_torch import main2
    with pytest.raises(error, match=match):
        main2.main(_cli(*argv))


def test_main2_defaults_to_the_card():
    """--device defaults to cuda; without a card it raises, never a quiet
    CPU run."""
    from audio_motion_avatar_tpu_torch import main2
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert main2.parse_args(["--mode", "demo"]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        main2.main(["--config", str(PORT_CONFIG), "--mode", "demo"])


def test_main2_prewarm_runs_one_rollout(tmp_path, capsys):
    from audio_motion_avatar_tpu_torch import main2
    assert main2.main(_cli("--mode", "demo", "--prewarm", f"training.output_dir={tmp_path}",
                           "dataset.image_size=[32,32]")) is None
    out = capsys.readouterr().out
    assert "first rollout" in out and "--prewarm" in out and "wrote" not in out
    assert not (tmp_path / "demo_outputs" / "frames").exists()


def test_main2_demo_imports_a_reference_checkpoint(tmp_path, capsys):
    """--checkpoint FILE: a Lightning .ckpt with the reference's names (the
    five gaussian heads and the audio transformer's output projection, at
    the tiny model's shapes) is imported into the stage-2 model before the
    demo's first rollout; the upsampler norm defaults to 'affine'."""
    from audio_motion_avatar_tpu_torch import main2
    from audio_motion_avatar_tpu_torch.configs import ConfigLoader
    from audio_motion_avatar_tpu_torch.configs.build import (build_avatar_config,
                                                             default_affine_norm_for_import)
    cfg = ConfigLoader.load_config(str(PORT_CONFIG), ["dataset.image_size=[32,32]"])
    model = main2.build_stage2(cfg, build_avatar_config(cfg), torch.device("cpu")).model
    sd = model.state_dict()
    g = torch.Generator().manual_seed(0)
    ref = {}
    for name in ("xyz_layer", "rotation_layer", "scaling_layer", "opacity_layer", "shs_layer"):
        for leaf in ("weight", "bias"):
            v = sd[f"triplane_gaussian.renderer.{name}.{leaf}"]
            ref[f"triplane_gaussian.renderer.gaussian_decoder.{name}.{leaf}"] = \
                v + 1e-2 * torch.randn(v.shape, generator=g)
    for leaf in ("weight", "bias"):
        ref[f"audio_triplane.transformer.proj_out.{leaf}"] = \
            0.1 * sd[f"audio_triplane.transformer.proj_out.{leaf}"]
    path = str(tmp_path / "reference.ckpt")
    torch.save({"epoch": 0, "global_step": 0, "hyper_parameters": {}, "state_dict": ref}, path)
    assert main2.main(_cli("--mode", "demo", "--prewarm", "--checkpoint", path,
                           f"training.output_dir={tmp_path}", "dataset.image_size=[32,32]")) is None
    out = capsys.readouterr().out
    assert "[main2] torch import: 6 tensors from 6 torch modules; skipped=[]; mismatches=[]" in out
    assert "first rollout" in out
    affine = default_affine_norm_for_import(cfg, path)
    assert affine["model"]["renderer"]["upsampler_norm"] == "affine"


def test_main_builder_and_output_dirs(tmp_path):
    """main.py's shared pieces: build_everything gives the stage-1 model on
    the config's body (400 synthetic vertices on the tiny profile), and
    setup_output_dirs the run's directories and config.yaml, which reads
    back as the config."""
    from audio_motion_avatar_tpu_torch import main
    from audio_motion_avatar_tpu_torch.configs import ConfigLoader
    from audio_motion_avatar_tpu_torch.models.avatar import TriplaneGaussianAvatar
    cfg = ConfigLoader.load_config(str(PORT_CONFIG), [f"training.output_dir={tmp_path}"])
    model, statics, ac = main.build_everything(cfg, "cpu")
    assert isinstance(model, TriplaneGaussianAvatar) and not model.training
    assert statics.smplx_model.v_template.shape == (400, 3) and ac.triplane_resolution == 8
    main.setup_output_dirs(cfg)
    assert sorted(os.listdir(tmp_path)) == ["checkpoints", "config.yaml", "target_images",
                                            "test_images", "train_images"]
    from audio_motion_avatar_tpu_torch.configs import yaml_subset
    assert yaml_subset.load(str(tmp_path / "config.yaml")) == cfg.to_dict()
