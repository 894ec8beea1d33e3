"""The port's YAML configs (configs/loader.py, configs/yaml_subset.py,
configs/build.py) against the JAX package's on the same files: the merged
trees, the built AvatarConfig / OptimConfig field by field, the knobs the
port drops, and the parser against PyYAML's safe_load. No jit: seconds."""

import dataclasses
import filecmp
import math
from pathlib import Path

import pytest
import torch
import yaml

from audio_motion_avatar_tpu.configs import ConfigLoader as JaxLoader
from audio_motion_avatar_tpu.configs import build as jax_build
from audio_motion_avatar_tpu_torch.configs import ConfigLoader
from audio_motion_avatar_tpu_torch.configs import build
from audio_motion_avatar_tpu_torch.configs import yaml_subset
from audio_motion_avatar_tpu_torch.models.config import PORT_ONLY_FIELDS

ROOT = Path(__file__).resolve().parents[1]
JAX_DIR = ROOT / "audio_motion_avatar_tpu" / "configs"
PORT_DIR = ROOT / "audio_motion_avatar_tpu_torch" / "configs"
CONFIGS = ["config_stage_1.yaml", "config_stage_1_idol.yaml", "config_stage_2.yaml",
           "config_tiny.yaml"]
OVERRIDES = ["model.demo_fuse_chunks=2", "model.renderer.upsampler_sparse_max_tiles=128",
             "model.renderer.frames_scan_unroll=4", "model.compute_dtype=bfloat16",
             "dataset.image_size=[512,512]", "training.learning_rate=2e-4"]
YAML_FILES = sorted(p.relative_to(JAX_DIR).as_posix() for p in JAX_DIR.rglob("*.yaml"))


def _load(name, overrides):
    return (JaxLoader.load_config(str(JAX_DIR / name), overrides),
            ConfigLoader.load_config(str(PORT_DIR / name), overrides))


@pytest.mark.parametrize("overrides", [[], OVERRIDES], ids=["plain", "overrides"])
@pytest.mark.parametrize("name", CONFIGS)
def test_merged_tree_matches_jax(name, overrides):
    j, p = _load(name, overrides)
    assert p.to_dict() == j.to_dict()
    assert isinstance(p.model.triplane_net, dict) and p.model.triplane_net.radius == 1.4


@pytest.mark.parametrize("serving", [False, True], ids=["yaml", "serving"])
@pytest.mark.parametrize("name", CONFIGS)
def test_avatar_config_matches_jax(name, serving):
    """Every field of the port's AvatarConfig equals the JAX field of the
    same name, with and without the serving overlay, with the overrides."""
    for overrides in ([], OVERRIDES):
        j, p = _load(name, overrides)
        want, got = jax_build.build_avatar_config(j), build.build_avatar_config(p)
        if serving:
            want, got = jax_build.apply_serving_profile(want, j), build.apply_serving_profile(got, p)
        for f in dataclasses.fields(got):
            if f.name in PORT_ONLY_FIELDS:      # the JAX package's form by default
                assert getattr(got, f.name) == PORT_ONLY_FIELDS[f.name], f.name
                continue
            assert getattr(got, f.name) == getattr(want, f.name), (overrides, f.name)
    assert got.demo_fuse_chunks == 2 and got.compute_dtype == "bfloat16"


@pytest.mark.parametrize("name", CONFIGS)
def test_optim_config_matches_jax(name):
    for overrides in ([], OVERRIDES):
        j, p = _load(name, overrides)
        assert dataclasses.asdict(build.build_optim_config(p)) == \
            dataclasses.asdict(jax_build.build_optim_config(j))


def test_learning_rate_string_floated():
    """`learning_rate: 1e-4` is the string '1e-4' under YAML 1.1, in both."""
    j, p = _load("config_stage_2.yaml", [])
    assert p.training.learning_rate == j.training.learning_rate == "1e-4"
    assert build.build_optim_config(p).learning_rate == 1e-4


@pytest.mark.parametrize("checkpoint", [None, "dir", "file"])
@pytest.mark.parametrize("explicit", [False, True])
def test_default_affine_norm_for_import(tmp_path, checkpoint, explicit):
    path = {None: None, "dir": str(tmp_path), "file": str(tmp_path / "x.ckpt")}[checkpoint]
    ov = ["model.renderer.upsampler_norm=group"] if explicit else []
    j, p = _load("config_stage_2.yaml", ov)
    got = build.default_affine_norm_for_import(p, path).to_dict()
    assert got == jax_build.default_affine_norm_for_import(j, path).to_dict()
    want = "group" if explicit else ("affine" if checkpoint == "file" else None)
    assert got["model"]["renderer"].get("upsampler_norm") == want


@pytest.mark.parametrize("override", [
    "model.renderer.sample_slab=true", "model.renderer.upsampler_sparse_penultimate=true",
    "model.sample_slab=true"])
@pytest.mark.parametrize("name", ["config_stage_2.yaml", "config_tiny.yaml"])
def test_refused_knobs_raise_by_name(name, override):
    """The knobs the port refused before it rendered their forms (slab
    sampling, the sparse penultimate level) now build: the config equals
    the JAX build field for field, with the knob set."""
    j, p = _load(name, [override])
    knob = override.split("=")[0].split(".")[-1]
    want, got = jax_build.build_avatar_config(j), build.build_avatar_config(p)
    assert getattr(got, knob) is True
    for f in dataclasses.fields(got):
        if f.name in PORT_ONLY_FIELDS:
            assert getattr(got, f.name) == PORT_ONLY_FIELDS[f.name], f.name
            continue
        assert getattr(got, f.name) == getattr(want, f.name), f.name


@pytest.mark.parametrize("override", [
    "model.renderer.quad_builder=xla", "model.quad_builder=pallas",
    "model.renderer.frames_scan_unroll=3", "model.splat_mode=naive",
    "model.renderer.upsampler_sparse_pen_max_tiles=64",
    "model.renderer.sample_slab=false"])
def test_ignored_knobs_accepted(override):
    """Knobs whose every value computes the same function are dropped: the
    config equals the one built without them. The two the port reads since
    it renders their forms (upsampler_sparse_pen_max_tiles, sample_slab)
    change that field alone, to the JAX build's value."""
    j, p = _load("config_stage_2.yaml", [override])
    _, base = _load("config_stage_2.yaml", [])
    knob = override.split("=")[0].split(".")[-1]
    got, plain = build.build_avatar_config(p), build.build_avatar_config(base)
    if knob in build.IGNORED_KNOBS:
        assert got == plain
        return
    assert getattr(got, knob) == getattr(jax_build.build_avatar_config(j), knob)
    assert dataclasses.replace(got, **{knob: getattr(plain, knob)}) == plain


def test_dtype_refusal_names_the_override():
    """On the card an fp32 config with 64-wide heads raises, naming the
    override that fixes it (config_stage_2.yaml leaves float32)."""
    from audio_motion_avatar_tpu_torch.serve import check_kernel_dtype
    _, p = _load("config_stage_2.yaml", [])
    ac = build.apply_serving_profile(build.build_avatar_config(p), p)
    with pytest.raises(ValueError, match="model.compute_dtype=bfloat16"):
        check_kernel_dtype(ac, torch.device("cuda"), stage1=True)
    _, p = _load("config_stage_2.yaml", ["model.compute_dtype=bfloat16"])
    check_kernel_dtype(build.build_avatar_config(p), torch.device("cuda"), stage1=True)


@pytest.mark.parametrize("name", YAML_FILES)
def test_yaml_copies_identical(name):
    assert filecmp.cmp(JAX_DIR / name, PORT_DIR / name, shallow=False)
    assert sorted(p.relative_to(PORT_DIR).as_posix() for p in PORT_DIR.rglob("*.yaml")) \
        == YAML_FILES


@pytest.mark.parametrize("name", YAML_FILES)
def test_parser_equals_pyyaml_on_files(name):
    text = (JAX_DIR / name).read_text()
    assert yaml_subset.loads(text) == yaml.safe_load(text)


SNIPPETS = [
    "1e-4", "1.0e-4", "1.0e4", "5e-5", "0.5", ".5", "-.inf", "+.Inf", "1_000", "012",
    "0x1F", "0b101", "1:30", "1:30.5", "-7", "+12", "-0", "08", "1.", "-1.5e+3",
    "3.14_15", "1.0E-3", "true", "True", "yes", "off", "ON", "n", "y", "null", "~", "NULL",
    "", "[512,512]", "[512, 512]", "[]", "{}", "{a: 1, b: [2, 3]}", "{a: }", "[1, [2, [3]]]",
    "[a, 'b, c', \"d\"]", "bfloat16", "/tmp/x y", "'it''s'", '"a\\tb\\u00e9"', "'#not'",
    "x # comment", "${a.b}*3", "http://x.y:80/z", "a b c", "a: 1", "a:\n  b: 2\n  c: [1]",
    "- a\n- b", "key:\n- 1\n- 2\nother: 3", "- a: 1\n  b: 2\n- c", "- - 1\n  - 2\n- 3",
    "a:\n  - x\n  - y\nb: 1", "k: 'v' # c", "- \n- x", "---\na: 1", "a:   # c\n  b: 1",
    "a:\n  b:\n  c: 2", "'quoted key': 1", "1: one", "a: [b, {c: d}]",
]


@pytest.mark.parametrize("text", SNIPPETS)
def test_parser_equals_pyyaml(text):
    want, got = yaml.safe_load(text), yaml_subset.loads(text)
    if isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("text", ["a: b: c", "[1, 2] x", "&a 1", "*a", "!!str 1",
                                  "a: |\n  x", "2001-12-14", "'open", "a:\n\tb: 1",
                                  "---\na: 1\n---\nb: 2"])
def test_parser_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        yaml_subset.loads(text)
