"""The port's tracer (utils/profiling.py): spans, requests, host-sync counts
and records, on the tiny profile (CPU), and the host-sync counter against
CUDA's own sync debug mode on the card (marked `gpu`).

This file imports no JAX, so the `gpu` test runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -q -m gpu
"""

import collections
import os
import subprocess
import sys
import warnings

import pytest
import torch

from audio_motion_avatar_tpu_torch.data.synthetic import make_batch, to_device
from audio_motion_avatar_tpu_torch.models.config import AvatarConfig, serving_config
from audio_motion_avatar_tpu_torch.ops import smplx as tsmplx
from audio_motion_avatar_tpu_torch.reconstruct import build_reconstructor
from audio_motion_avatar_tpu_torch.serve import build_rollout, synthetic_inputs
from audio_motion_avatar_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_OVERRIDES = dict(num_upsample_blocks=2, max_per_tile=512, upsampler_sparse_max_tiles=3,
                       upsampler_norm="affine", compute_dtype="float32", frames_per_chunk=6)
RENDER = ("render.body", "render.upsample", "render.sample", "render.refine", "render.splat")
# the host syncs of one tiny request by site (on the CPU every site counts
# where it is passed; kernel S, on the card, reads no kmax)
SERVE_SYNCS = {"smplx.parents": 1, "smplx.bottom": 1, "upsampler.t4": 4, "splat.kmax": 2}
RECON_SYNCS = {"image_encoder.normalize": 2, "image_encoder.resize": 2, "smplx.parents": 2,
               "smplx.bottom": 2, "subdivision.faces": 1, "upsampler.t4": 2,
               "losses.ssim_window": 2, "recon.metrics": 14}


@pytest.fixture
def tracer():
    """The tracer on with an empty ring; off and empty afterwards."""
    profiling.reset()
    profiling.enable()
    yield profiling
    profiling.disable()
    profiling.reset()


@pytest.fixture(scope="module")
def tiny():
    """A tiny serving rollout and a tiny reconstructor with their inputs
    (seeded weights), as {"serve": fn, "recon": fn}: each fn runs one
    request and returns its answer."""
    torch.manual_seed(0)
    body = tsmplx.synthetic_model(seed=0, num_verts=300)
    cfg = serving_config(AvatarConfig.tiny(image_size=(32, 32)), **SERVE_OVERRIDES)
    roll = build_rollout(cfg, device="cpu", smplx_model=body)
    inputs = synthetic_inputs(cfg, 2, "cpu")
    rec = build_reconstructor(AvatarConfig.tiny(), device="cpu", smplx_model=body)
    ref = to_device(make_batch(1, 2, (64, 64), seed=30), "cpu")
    test = to_device(make_batch(1, 3, (64, 64), seed=31), "cpu")
    return {"serve": lambda: roll(*inputs), "recon": lambda: rec(ref, test)}


def names(record):
    return [s["name"] for s in record["spans"]]


def flat(out):
    """Every tensor and float of an answer, in order."""
    if torch.is_tensor(out) or isinstance(out, float):
        return [out]
    if isinstance(out, dict):
        return [x for k in sorted(out) for x in flat(out[k])]
    if isinstance(out, (tuple, list)):
        return [x for v in out for x in flat(v)]
    return []


def test_off_by_default():
    """A fresh process that imports the entry points has the tracer off."""
    code = ("import audio_motion_avatar_tpu_torch.serve, audio_motion_avatar_tpu_torch.reconstruct\n"
            "from audio_motion_avatar_tpu_torch.utils import profiling as p\n"
            "assert not p.TRACER.on and p.span('x') is p.NOOP and p.request('x') is p.NOOP\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT, timeout=300)


def test_off_path_is_the_shared_noop(tiny):
    profiling.disable()
    profiling.reset()
    assert profiling.span("render.body") is profiling.NOOP
    assert profiling.request("serve.request", "cuda") is profiling.NOOP
    assert profiling.host_sync("site") is profiling.NOOP
    tiny["serve"]()
    assert profiling.records() == []


def test_serve_request_spans(tiny, tracer):
    tiny["serve"]()
    tiny["serve"]()
    recs = profiling.records()
    assert [r["name"] for r in recs] == ["serve.request"] * 2
    assert recs[0]["id"] != recs[1]["id"]
    for r in recs:
        got = names(r)
        assert set(got) == {"serve.request", "decode", *RENDER}
        assert got[0] == "serve.request" and r["spans"][0]["parent"] is None
        assert all(s["parent"] == "serve.request" for s in r["spans"][1:])
        # 12 frames in 2 chunks of 6: the quad build and two samplings a chunk
        assert [got.count(n) for n in ("decode",) + RENDER] == [1, 1, 2, 6, 2, 2]


def test_recon_request_spans(tiny, tracer):
    tiny["recon"]()
    (r,) = profiling.records()
    got = names(r)
    assert r["name"] == "recon.request" and got[0] == "recon.request"
    assert set(got) == {"recon.request", "recon.novel", "recon.loss", *RENDER}
    assert got.count("recon.loss") == 3 and got.count("recon.novel") == 1
    assert all(s["parent"] == "recon.request" for s in r["spans"][1:])


@pytest.mark.parametrize("kind", ["serve", "recon"])
def test_answers_bit_identical_tracer_on_and_off(tiny, kind):
    profiling.disable()
    off = flat(tiny[kind]())
    profiling.enable()
    try:
        on = flat(tiny[kind]())
    finally:
        profiling.disable()
        profiling.reset()
    assert len(on) == len(off) > 3
    for a, b in zip(on, off):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b


@pytest.mark.parametrize("kind,want", [("serve", SERVE_SYNCS), ("recon", RECON_SYNCS)])
def test_host_syncs_a_request(tiny, tracer, kind, want):
    """Per request in the record with the tracer on, and in the process's
    count with it off."""
    tiny[kind]()
    (r,) = profiling.records()
    assert r["syncs"] == want
    profiling.disable()
    before = profiling.syncs()
    tiny[kind]()
    after = profiling.syncs()
    assert {k: after[k] - before.get(k, 0) for k in after} == want


def test_ring_is_bounded(monkeypatch):
    assert profiling.RING >= 4096
    monkeypatch.setattr(profiling, "TRACER", profiling.Tracer(ring=8))
    profiling.enable()
    for _ in range(20):
        with profiling.request("r", "cpu"):
            with profiling.span("s"):
                pass
    recs = profiling.records()
    assert len(recs) == 8 and [r["id"] for r in recs] == list(range(12, 20))


def test_profiler_sees_spans_only_in_trace(tiny, tracer, tmp_path):
    """An outside profiler run sees no range of the tracer's (each would
    also be a device-side annotation); `trace` adds them."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tiny["serve"]()
    seen = {e.name for e in prof.events()}
    assert not seen & {"serve.request", "decode", *RENDER}
    profiling.disable()
    with profiling.trace(str(tmp_path)) as prof:
        assert profiling.TRACER.on
        tiny["serve"]()
    seen = {e.name for e in prof.events()}
    assert {"serve.request", "decode", *RENDER} <= seen
    assert any(tmp_path.iterdir())
    assert not profiling.TRACER.on and not profiling.TRACER.annotate


def test_records_resolve_host_times_on_cpu(tiny, tracer):
    tiny["serve"]()
    (r,) = profiling.records()
    top = r["spans"][0]
    for s in r["spans"]:
        assert top["host_start_ns"] <= s["host_start_ns"] <= s["host_end_ns"] <= top["host_end_ns"]
        assert s["host_ms"] == pytest.approx((s["host_end_ns"] - s["host_start_ns"]) * 1e-6)
        assert s["device_ms"] is s["device_start_ns"] is s["device_end_ns"] is None
    # the children do not overlap one another
    kids = r["spans"][1:]
    assert all(a["host_end_ns"] <= b["host_start_ns"] for a, b in zip(kids, kids[1:]))


def test_nested_request_is_a_span(tracer):
    with profiling.request("outer", "cpu"):
        with profiling.request("inner", "cpu"):
            with profiling.span("leaf"):
                pass
            with profiling.host_sync("site"):
                pass
    (r,) = profiling.records()
    assert [(s["name"], s["parent"]) for s in r["spans"]] == [
        ("outer", None), ("inner", "outer"), ("leaf", "inner")]
    assert r["syncs"] == {"site": 1}


# ---- on the card -------------------------------------------------------------

def card_config(name: str) -> AvatarConfig:
    """The shipped YAML as the port's entry points build it, in bf16 (the
    card path); the stage-2 one with the serving profile, as the demo."""
    from audio_motion_avatar_tpu_torch.configs import ConfigLoader
    from audio_motion_avatar_tpu_torch.configs.build import (apply_serving_profile,
                                                            build_avatar_config)
    from audio_motion_avatar_tpu_torch.serve import BF16_OVERRIDE

    cfg = ConfigLoader.load_config(
        os.path.join(ROOT, "audio_motion_avatar_tpu_torch", "configs", name), [BF16_OVERRIDE])
    ac = build_avatar_config(cfg)
    return apply_serving_profile(ac, cfg) if "stage_2" in name else ac


def card_request(kind: str, dev):
    """One request of the configuration on the card, as a function."""
    if kind == "serve":
        cfg = card_config("config_stage_2.yaml")
        roll = build_rollout(cfg, device=dev, dtype=torch.bfloat16)
        inputs = synthetic_inputs(cfg, 2, dev)
        return lambda: roll(*inputs)
    cfg = card_config("config_stage_1.yaml")
    rec = build_reconstructor(cfg, device=dev, dtype=torch.bfloat16)
    ref = to_device(make_batch(1, 1, cfg.image_size, seed=30), dev)
    test = to_device(make_batch(1, 8, cfg.image_size, seed=31), dev)
    return lambda: rec(ref, test)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["serve", "recon"])
def test_host_sync_counter_matches_cuda_sync_debug_mode(kind):
    """One request of each shipped configuration: the counter's total
    equals the warnings torch.cuda.set_sync_debug_mode("warn") raises
    inside it; with the tracer on, every span has device times, its edges
    on the host clock after its host entry and inside the request's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sync debug mode and CUDA events are the card's")
    dev = torch.device("cuda", 0)
    one = card_request(kind, dev)
    one()                                            # builds the kernels, warms up
    torch.cuda.synchronize()
    before = sum(profiling.syncs().values())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            one()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # the mode's own notice, the first time it is set, is no sync
    syncing = [w for w in caught if "called a synchronizing" in str(w.message)]
    where = collections.Counter(f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in syncing)
    assert sum(profiling.syncs().values()) - before == len(syncing) > 0, where

    profiling.reset()
    profiling.enable()
    try:
        one()
        (r,) = profiling.records()
    finally:
        profiling.disable()
        profiling.reset()
    top = r["spans"][0]
    slack = 1_000_000                                # 1 ms: the anchor's own error
    for s in r["spans"]:
        assert s["device_ms"] is not None and s["device_ms"] >= 0
        assert s["device_start_ns"] >= s["host_start_ns"] - slack
        assert top["device_start_ns"] - slack <= s["device_start_ns"] <= s["device_end_ns"] \
            <= top["device_end_ns"] + slack
