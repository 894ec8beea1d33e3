"""Training with the quad sampler: kernel Q's backward against the JAX package.

(a) `ops/triplane.quad_rows_bwd_plain`, the plain version of kernel Q-bwd,
against `jax.vjp` of the JAX `quad_rows` on numpy-seeded tiles and
cotangents, in every coverage that `select_tiles` leaves: full, partial
with holes, fewer covered tiles than slots (the unused slots all take tile
0's neighbours, so tiles 1, grid and grid + 1 collect many sources; tile 0
covered and not), and tiles on the grid's right and bottom edges; plus
`incoming_slots` against the definition, and chip_smoke.py's yardsticks
(one index_select / index_add_ through `quad_gather_index`) against the
plain Q and Q-bwd. (b) `QuadRowsFunction` through
`torch.autograd.gradcheck` in float64. (c) One stage-1 train step in the
sparse + quad form (tests/test_torch_render_forms.py's TRAIN_FORM with
sample_quad) against the JAX step. (d) One tiny stage-2 step in the quad
form against the same step in the 4-tap form under full coverage, where the
two samplers compute the same function (no JAX). Also the kernels' calls
of a train step in the quad form against the count chip_smoke.py holds the
card's launches to.

Tolerances: (a) float32 atol 1e-6 (one reordered float32 sum of a few
terms in [-1, 1)); index_add_ within 2 (n - 1) 2^-24 of the sum of its n
terms' magnitudes (its sums in another order; index_select is a copy,
bit-exact); bfloat16 within two bf16 units of the larger of the two
values, elementwise, against the JAX vjp taken in float32 of the same bf16
values (the port sums in float32 and rounds once; the JAX vjp in bf16 rounds
every partial sum, which moves a cancelling sum by more); (c) loss and
grad_norm 1e-4 relative, leaves as `leaves_close`; (d) loss equal to 1e-6
relative, grad_norm 1e-5 relative and every gradient leaf within 1e-5 of its
norm (the same sums, the tiles' gradient added in another order).
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from audio_motion_avatar_tpu.data.synthetic import make_batch
from audio_motion_avatar_tpu.models.avatar import TriplaneGaussianAvatar as JaxAvatar
from audio_motion_avatar_tpu.models.config import AvatarConfig as JaxConfig
from audio_motion_avatar_tpu.models.renderer import build_renderer_statics
from audio_motion_avatar_tpu.ops import smplx as jsmplx
from audio_motion_avatar_tpu.ops import triplane as jtp
from audio_motion_avatar_tpu.training import stage1 as jstage1
from audio_motion_avatar_tpu.training import train_state as jts

from audio_motion_avatar_tpu_torch.data.synthetic import make_batch as tmake_batch
from audio_motion_avatar_tpu_torch.data.synthetic import to_device
from audio_motion_avatar_tpu_torch.models import renderer
from audio_motion_avatar_tpu_torch.models.config import AvatarConfig
from audio_motion_avatar_tpu_torch.ops import smplx as tsmplx
from audio_motion_avatar_tpu_torch.ops import triplane as ttp
from audio_motion_avatar_tpu_torch.train import build_trainer
from audio_motion_avatar_tpu_torch.training.train_state import OptimConfig
from audio_motion_avatar_tpu_torch.weights import params_from_flax, perturb_heads
from test_torch_render_forms import TRAIN_FORM, jitted
from test_torch_train_stage1 import FAST_COMPILE, LR, SIZE, leaves_close, recording, visible
from torch_parity import one_torch_thread, random_params  # noqa: F401

# --- (a) the plain backward against jax.vjp ---------------------------------

GRID, T, C = 4, 3, 8
# name -> (covered tile ids, cap); slots rank the covered ids in order
# (two caps, so the JAX vjp compiles twice a dtype)
COVERAGE = {"full": (np.arange(16), 16),
            "holes": (np.array([0, 1, 2, 5, 6, 9, 10, 15]), 8),
            "unused, tile 0 covered": (np.array([0, 1, 4, 5, 10]), 8),
            "unused, tile 0 not covered": (np.array([1, 4, 5, 6]), 8),
            "right and bottom edges": (np.array([3, 7, 10, 11, 12, 13, 14, 15]), 8)}


def _quad_case(name, seed, dtype=torch.float32):
    """Two planes (FP = 2) of `name`'s coverage with their own tiles and
    cotangents in [-1, 1): (tiles, dquad, slot) as numpy, the values
    rounded to `dtype`."""
    keep, cap = COVERAGE[name]
    rng = np.random.RandomState(seed)
    slot = np.full(GRID * GRID, -1, np.int64)
    slot[keep] = np.arange(len(keep))
    tiles = rng.uniform(-1, 1, (2, cap, T, T, C)).astype(np.float32)
    dquad = rng.uniform(-1, 1, (2, cap, T, T, 4 * C)).astype(np.float32)
    rounded = [torch.tensor(a).to(dtype).float().numpy() for a in (tiles, dquad)]
    return rounded[0], rounded[1], np.stack([slot, slot])


_VJP = {}


def _jax_vjp(tiles, dquad, slot, dtype=jnp.float32):
    """jax.vjp of the JAX quad_rows (vmapped over the planes) at the tiles,
    applied to dquad, in `dtype`, as float32 numpy (compiled once a shape
    and dtype)."""
    def vjp(t, s, d):
        _, back = jax.vjp(lambda x: jax.vmap(lambda a, b: jtp.quad_rows(a, b, GRID))(x, s), t)
        return back(d)[0].astype(jnp.float32)
    args = (jnp.asarray(tiles, dtype), jnp.asarray(slot, jnp.int32), jnp.asarray(dquad, dtype))
    key = (tiles.shape, jnp.dtype(dtype).name)
    if key not in _VJP:
        _VJP[key] = jax.jit(vjp).lower(*args).compile(compiler_options=FAST_COMPILE)
    return np.asarray(_VJP[key](*args))


@pytest.mark.parametrize("coverage", list(COVERAGE))
def test_quad_rows_bwd_plain_matches_jax_vjp_fp32(coverage):
    tiles, dquad, slot = _quad_case(coverage, 1)
    want = _jax_vjp(tiles, dquad, slot)
    got = ttp.quad_rows_bwd_plain(torch.tensor(dquad), torch.tensor(slot), GRID)
    assert got.dtype == torch.float32 and got.shape == tiles.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("coverage", list(COVERAGE))
def test_quad_rows_bwd_plain_matches_jax_vjp_bf16(coverage):
    tiles, dquad, slot = _quad_case(coverage, 2, torch.bfloat16)
    want = _jax_vjp(tiles, dquad, slot)
    got = ttp.quad_rows_bwd_plain(torch.tensor(dquad).bfloat16(), torch.tensor(slot), GRID)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    larger = np.maximum(np.abs(got), np.abs(want))
    unit = 2.0 ** (np.floor(np.log2(np.maximum(larger, np.finfo(np.float32).tiny))) - 7)
    assert (np.abs(got - want) <= 2 * unit).all(), float((np.abs(got - want) / unit).max())
    # and the JAX vjp in bf16 itself, within the size of its own roundings
    # (one bf16 unit of the sum of the terms' magnitudes a partial sum)
    mag = ttp.quad_rows_bwd_plain(torch.tensor(np.abs(dquad)), torch.tensor(slot), GRID).numpy()
    bf = _jax_vjp(tiles, dquad, slot, jnp.bfloat16)
    assert (np.abs(got - bf) <= 4 * 2.0 ** -8 * mag + 1e-30).all()


@pytest.mark.parametrize("coverage", list(COVERAGE))
def test_incoming_slots_invert_the_neighbour_table(coverage):
    """Every target's listed sources are exactly the slots naming it as
    their right / bottom / diagonal neighbour, ascending; the unused slots
    alias tile 0's neighbours (several sources for one target)."""
    keep, cap = COVERAGE[coverage]
    slot = torch.tensor(_quad_case(coverage, 0)[2])
    nbr = ttp.neighbor_table(slot, GRID, cap)
    src, start = ttp.incoming_slots(nbr, cap)
    assert src.dtype == start.dtype == torch.int32
    assert src.shape == (2, 3, cap) and start.shape == (2, 3, cap + 1)
    most = 0
    for f in range(2):
        for d in range(3):
            for u in range(cap):
                listed = src[f, d, start[f, d, u]:start[f, d, u + 1]].tolist()
                assert listed == [s for s in range(cap) if int(nbr[f, s, d]) == u], (f, d, u)
                most = max(most, len(listed))
    assert most == (cap - len(keep) + (0 in keep) if coverage.startswith("unused") else 1)


@pytest.mark.parametrize("coverage", list(COVERAGE))
def test_quad_gather_index_select_is_quad_rows(coverage):
    """chip_smoke.py's yardstick for kernel Q: one index_select through
    quad_gather_index equals the plain quad rows bit for bit."""
    tiles, _, slot = _quad_case(coverage, 3, torch.bfloat16)
    tiles, slot = torch.tensor(tiles).bfloat16(), torch.tensor(slot)
    index = chip_smoke.quad_gather_index(slot, GRID, tiles.shape[1], T)
    got = chip_smoke.quad_rows_library(tiles, index)()
    want = ttp.quad_rows_plain(tiles, slot, GRID)
    assert got.shape == want.shape
    assert torch.equal(chip_smoke.bits(got), chip_smoke.bits(want))


@pytest.mark.parametrize("coverage", list(COVERAGE))
def test_quad_gather_index_add_is_quad_rows_bwd(coverage):
    """... and for kernel Q-bwd: one index_add_ through the same index
    equals the plain backward within the reordering bound of an fp32 sum
    (chip_smoke.reordered_sum_bound over the most terms an output sums)."""
    _, dquad, slot = _quad_case(coverage, 4)
    dquad, slot = torch.tensor(dquad), torch.tensor(slot)
    cap = dquad.shape[1]
    incoming = ttp.incoming_slots(ttp.neighbor_table(slot, GRID, cap), cap)
    most = int((incoming[1][..., 1:] - incoming[1][..., :-1]).max())
    index = chip_smoke.quad_gather_index(slot, GRID, cap, T)
    got = chip_smoke.quad_rows_bwd_library(dquad, index)()
    want = ttp.quad_rows_bwd_plain(dquad, slot, GRID, incoming)
    tol = chip_smoke.reordered_sum_bound(
        ttp.quad_rows_bwd_plain(dquad.abs(), slot, GRID, incoming), 2 * most + 2)
    assert got.shape == want.shape
    assert ((got - want).abs() <= tol).all(), float(((got - want).abs() - tol).max())


@pytest.mark.parametrize("coverage", ["unused, tile 0 covered", "unused, tile 0 not covered"])
def test_quad_rows_function_gradcheck(coverage):
    """QuadRowsFunction's backward (the plain Q-bwd on the CPU) is the
    Jacobian's transpose, in float64 at a tiny shape (T = 2, C = 2)."""
    keep, cap = COVERAGE[coverage]
    slot = torch.tensor(_quad_case(coverage, 0)[2])
    x = torch.tensor(np.random.RandomState(3).randn(2, cap, 2, 2, 2), requires_grad=True)
    assert torch.autograd.gradcheck(lambda t: ttp.QuadRowsFunction.apply(t, slot, GRID), (x,))


def test_build_quad_differentiates_only_under_autograd():
    """build_quad goes through the Function where the tiles need a gradient,
    and calls Q directly otherwise (serving): the same rows either way."""
    tiles, _, slot = _quad_case("holes", 4)
    t = torch.tensor(tiles).reshape(1, 2, *tiles.shape[1:]).requires_grad_(True)
    s = torch.tensor(slot).reshape(1, 2, -1)
    q = ttp.build_quad(t, s, GRID)
    assert type(q.grad_fn.next_functions[0][0]).__name__ == "QuadRowsFunctionBackward"
    with torch.no_grad():
        assert torch.equal(ttp.build_quad(t, s, GRID), q.detach())
    g = torch.tensor(np.random.RandomState(5).randn(*q.shape).astype(np.float32))
    q.backward(g)
    want = ttp.quad_rows_bwd_plain(g.reshape(2, *g.shape[2:]), s.reshape(2, -1), GRID)
    assert torch.equal(t.grad.reshape(want.shape), want)


def test_quad_rows_bwd_refuses_what_the_kernel_does_not_take():
    """No fallback: a tensor off the CPU goes to the kernel's checks, which
    raise on a device that is not CUDA."""
    with pytest.raises(ValueError, match="unsupported device"):
        ttp.quad_rows_bwd(torch.zeros(1, 1, 2, 2, 32, device="meta"),
                          torch.zeros(1, 4, dtype=torch.long, device="meta"), 2)


# --- (c) one stage-1 train step in the quad form against JAX ----------------

@contextlib.contextmanager
def recorded_slots():
    """The slot maps of every quad-row build the renderer makes inside the
    block, in a list."""
    slots, build = [], renderer.build_quad

    def spy(tiles, slot, grid):
        slots.append(slot.detach().clone())
        return build(tiles, slot, grid)

    renderer.build_quad = spy
    try:
        yield slots
    finally:
        renderer.build_quad = build


# TRAIN_FORM's 6 slots a plane are all taken by this batch's covered tiles;
# with a slot for every tile of the grid (16) a plane leaves one unused, whose
# quad rows alias tile 0's neighbours (what Q-bwd must transpose)
QUAD_FORM = dict(TRAIN_FORM, sample_quad=True, upsampler_sparse_max_tiles=16)


@pytest.fixture(scope="module")
def quad_step():
    """One stage-1 train step of the JAX package and of the port in
    QUAD_FORM (tests/test_torch_render_forms.py's step in the quad form), the
    port's ViT fed the JAX ViT's tokens; the port's slot maps recorded."""
    jcfg = dataclasses.replace(JaxConfig.tiny(image_size=SIZE), frames_scan_remat=False,
                               **QUAD_FORM)
    jmodel = jsmplx.synthetic_model(seed=0, num_verts=300)
    statics = build_renderer_statics(jmodel, subdivide_steps=jcfg.subdivide_steps,
                                     densify=jcfg.densify_smplx_verts)
    nverts = 300 + np.asarray(jmodel.faces).shape[0]
    model = JaxAvatar(cfg=jcfg, num_verts_encoder=nverts, point_refiner=None)
    ref, test = make_batch(1, 1, SIZE, seed=40), make_batch(1, 3, SIZE, seed=41)
    jref, jtest = (jax.tree_util.tree_map(jnp.asarray, b) for b in (ref, test))
    params = visible(random_params(model, 42, statics, jref.video, jref.smpl_parms,
                                   jref.cam_parms))
    optim = dict(learning_rate=LR, total_steps=100)
    state = jts.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                                  recording(jts.make_optimizer(jts.OptimConfig(**optim))))
    step = jstage1.make_train_step(model, statics, jcfg, with_test_views=True, donate=False)
    new_state, metrics = step.lower(state, jref, jtest).compile(
        compiler_options=FAST_COMPILE)(state, jref, jtest)
    tokens = jitted(lambda p, v: model.apply(
        {"params": p}, v, method=lambda m, x: m.sapiens_encoder(x.reshape((-1,) + x.shape[2:]))),
        state.params, jref.video)

    cfg = dataclasses.replace(AvatarConfig.tiny(image_size=SIZE), **QUAD_FORM)
    tr = build_trainer(1, cfg, device="cpu",
                       smplx_model=tsmplx.synthetic_model(seed=0, num_verts=300),
                       state_dict=params_from_flax(params), optim=OptimConfig(**optim))
    flat = torch.tensor(np.asarray(tokens))
    tr.model.sapiens_encoder.forward = lambda images: flat
    with recorded_slots() as slots:
        got = tr.step(to_device(tmake_batch(1, 1, SIZE, seed=40), "cpu"),
                      to_device(tmake_batch(1, 3, SIZE, seed=41), "cpu"))
    grads = params_from_flax(jax.tree_util.tree_map(np.asarray, new_state.opt_state[1]))
    return dict(tr=tr, got=got, grads=grads, slots=slots,
                metrics={k: float(v) for k, v in metrics.items()})


@pytest.mark.parametrize("views,keys", [
    ("reference", ("loss", "grad_norm", "l1_train", "ssim_train")),
    ("novel", ("l1_test", "ssim_test"))])
def test_quad_train_step_loss_and_grad_norm_match(quad_step, views, keys):
    got, want = quad_step["got"], quad_step["metrics"]
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert want["grad_norm"] > 0


def test_quad_train_step_gradients_match(quad_step):
    tr, want = quad_step["tr"], quad_step["grads"]
    got = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
           for k, p in tr.model.named_parameters() if not k.startswith("sapiens_encoder")}
    leaves_close(got, {k: v for k, v in want.items() if not k.startswith("sapiens_encoder")})


def test_quad_train_step_reaches_the_sparse_final_level(quad_step):
    """The sparse final level (block 0, its skip projection included) gets a
    gradient through the quad rows on both sides, in the form that leaves
    unused slots (the aliasing Q-bwd must transpose)."""
    tr, want = quad_step["tr"], quad_step["grads"]
    cfg = tr.model.renderer.cfg
    assert cfg.upsampler_sparse and cfg.sample_quad
    params = dict(tr.model.named_parameters())
    for k in ("renderer.upsampler.up_0.res.conv2.weight", "renderer.upsampler.skip_proj.weight"):
        assert float(want[k].abs().max()) > 0, k
        assert params[k].grad is not None and float(params[k].grad.abs().max()) > 0, k
    assert quad_step["slots"] and all(
        int((s >= 0).sum(-1).min()) < cfg.upsampler_sparse_max_tiles for s in quad_step["slots"])


# --- (d) stage 2: the quad form against the 4-tap form ----------------------

# tiles of 8 px on the tiny model's 16^2 final level: a 2 x 2 grid, every
# tile in the 3 x 3 neighbourhood of any point, so all four are covered
FULL = dict(upsampler_sparse=True, upsampler_sparse_tile_px=8, upsampler_sparse_max_tiles=4,
            no_point_refiner=True, triplane_output_frames=2)


@pytest.fixture(scope="module")
def stage2_forms():
    """One tiny stage-2 step (B = 1) from the same seeded weights and batch
    in the quad form and in the 4-tap form: {form: (metrics, gradients,
    slot maps seen)}."""
    body = tsmplx.synthetic_model(seed=0, num_verts=300)
    out = {}
    for form, quad in (("quad", True), ("4-tap", False)):
        cfg = dataclasses.replace(AvatarConfig.tiny(image_size=SIZE), sample_quad=quad, **FULL)
        tr = build_trainer(2, cfg, device="cpu", smplx_model=body, seed=0,
                           optim=OptimConfig(learning_rate=LR))
        perturb_heads(tr.model, seed=1, std=0.05)   # zero heads pass no gradient back
        ref = to_device(tmake_batch(1, cfg.triplane_input_frames, SIZE, seed=60), "cpu")
        tgt = to_device(tmake_batch(1, cfg.triplane_output_frames, SIZE, seed=61,
                                    with_audio=True, audio_dim=cfg.audio_feature_dim), "cpu")
        with recorded_slots() as slots:
            m = tr.step(ref, tgt)
        grads = {k: p.grad.clone() for k, p in tr.model.named_parameters() if p.grad is not None}
        out[form] = (m, grads, slots)
    return out


def test_stage2_quad_step_matches_the_4tap_step(stage2_forms):
    (mq, gq, slots), (mt, gt, none) = stage2_forms["quad"], stage2_forms["4-tap"]
    assert slots and not none and all(bool((s >= 0).all()) for s in slots)
    np.testing.assert_allclose(mq["loss"], mt["loss"], rtol=1e-6)
    np.testing.assert_allclose(mq["grad_norm"], mt["grad_norm"], rtol=1e-5)
    assert mt["grad_norm"] > 0


def test_stage2_quad_step_gradients_match_the_4tap_step(stage2_forms):
    (_, gq, _), (_, gt, _) = stage2_forms["quad"], stage2_forms["4-tap"]
    leaves_close(gq, gt, rel=1e-5)
    up = [k for k in gt if ".renderer.upsampler." in k]
    assert up and all(float(gq[k].abs().max()) > 0 for k in up if "conv2.weight" in k)


# --- the kernels' calls of a quad-form train step ---------------------------

@pytest.mark.parametrize("stage", [1, 2])
def test_quad_train_step_calls_match_the_expected_count(monkeypatch, stage):
    """Q and Q-bwd (their plain versions on the CPU) as often as
    chip_smoke.train_launches says: every frame chunk rendered builds its
    quad rows once, once more in its remat recompute under autograd, and
    transposes them once; stage 2's stage-1 pass builds them without
    autograd."""
    cfg = dataclasses.replace(AvatarConfig.tiny(image_size=SIZE), sample_quad=True,
                              triplane_output_frames=3, **{k: v for k, v in FULL.items()
                                                          if k != "triplane_output_frames"})
    tr = build_trainer(stage, cfg, device="cpu",
                       smplx_model=tsmplx.synthetic_model(seed=0, num_verts=300))
    B, T_in, T_out = (1, 1, 3) if stage == 1 else (1, cfg.triplane_input_frames, 3)
    calls = {"quad_rows": 0, "quad_rows_bwd": 0}
    for name, key in (("quad_rows_plain", "quad_rows"), ("quad_rows_bwd_plain", "quad_rows_bwd")):
        def counted(*a, _f=getattr(ttp, name), _k=key, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(ttp, name, counted)
    other = tmake_batch(B, T_out, SIZE, seed=1, with_audio=stage == 2,
                        audio_dim=cfg.audio_feature_dim)
    m = tr.step(to_device(tmake_batch(B, T_in, SIZE, seed=0), "cpu"), to_device(other, "cpu"))
    want = chip_smoke.train_launches(cfg, stage, B, T_in, T_out)
    assert calls == {k: want[k] for k in calls}, (calls, want)
    assert calls["quad_rows_bwd"] > 0 and np.isfinite(m["loss"])
