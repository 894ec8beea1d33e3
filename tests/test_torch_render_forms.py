"""The render forms beside the serving one: the port against the JAX package.

SH colours (ops/sh.py, ops/splat.sh_colors), the 4-tap and slab sparse
samplers with tile_halo, the sparse penultimate upsample level, the
encoder's TriplaneDownsampler and its scatter mean at 96^2 (the encoder's
upsample path whole: tests/test_torch_stage1.py), and the tiny serving
chunk rendered in each form: rgb False at SH degrees 0 and 1, the planes
without the upsampler, and the sparse upsampler sampled by slabs or four
taps; and one stage-1 train step with SH colours and the 4-tap sparse
upsampler, against the JAX package's step.

Same numpy-seeded inputs and weights on both sides (tests/torch_parity.py).
The chunk (without the point refiner, whose chunk is held in
tests/test_torch_rollout.py): the JAX chunk's tokens and SMPL-X params are
computed once (the form changes only the renderer), its renderer then
compiled for each form on those; the port runs the whole chunk in each form
from the same weights. The JAX references are compiled at XLA's lowest
optimisation level (`jitted`).

The train step (below): loss and grad_norm 1e-4 relative; every trainable
gradient leaf within 1e-3 of its norm (plus the noise floor of
tests/test_torch_train_stage1.py).

Tolerances: eval_sh 1e-6; samplers, SH colours and the tile halo 1e-6
(the same fp32 operations); the upsampler levels and the downsampler
1e-4 (reassociated fp32 convs and matmuls); the scatter mean at 96^2
bit for bit; the chunk's tokens and params 1e-4, frames mean |diff| <= 1e-3.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_motion_avatar_tpu.data.synthetic import make_batch
from audio_motion_avatar_tpu.models import upsampler as jup
from audio_motion_avatar_tpu.models.avatar import TriplaneGaussianAvatar as JaxAvatar
from audio_motion_avatar_tpu.models.config import AvatarConfig as JaxConfig
from audio_motion_avatar_tpu.models.renderer import build_renderer_statics
from audio_motion_avatar_tpu.ops import sh as jsh
from audio_motion_avatar_tpu.ops import smplx as jsmplx
from audio_motion_avatar_tpu.ops import splat as jsplat
from audio_motion_avatar_tpu.ops import triplane as jtp
from audio_motion_avatar_tpu.training import stage1 as jstage1
from audio_motion_avatar_tpu.training import train_state as jts

from audio_motion_avatar_tpu_torch.data.synthetic import make_batch as tmake_batch
from audio_motion_avatar_tpu_torch.data.synthetic import to_device
from audio_motion_avatar_tpu_torch.models import upsampler as tup
from audio_motion_avatar_tpu_torch.models.config import AvatarConfig, serving_config
from audio_motion_avatar_tpu_torch.ops import sh as tsh
from audio_motion_avatar_tpu_torch.ops import smplx as tsmplx
from audio_motion_avatar_tpu_torch.ops import splat as tsplat
from audio_motion_avatar_tpu_torch.ops import splat_tiles
from audio_motion_avatar_tpu_torch.ops import triplane as ttp
from audio_motion_avatar_tpu_torch.serve import build_rollout
from audio_motion_avatar_tpu_torch.train import build_trainer
from audio_motion_avatar_tpu_torch.training.train_state import OptimConfig
from audio_motion_avatar_tpu_torch.weights import params_from_flax
from test_torch_train_stage1 import FAST_COMPILE, LR, SIZE, leaves_close, recording, visible
from torch_parity import (jax_serving_avatar, load_flax, one_torch_thread,  # noqa: F401
                          random_params, t)

def jitted(fn, *args):
    """fn(*args) compiled by XLA's CPU backend at its lowest optimisation
    level (run op by op, the JAX functions here take several times longer;
    at the default level the compiles do)."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)


def unit_dirs(n, seed):
    d = np.random.RandomState(seed).randn(n, 3)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


# --- spherical harmonics ---------------------------------------------------

@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(deg):
    coeffs = np.random.RandomState(deg).randn(64, 3, (deg + 1) ** 2).astype(np.float32)
    dirs = unit_dirs(64, 10 + deg)
    want = np.asarray(jsh.eval_sh(deg, jnp.asarray(coeffs), jnp.asarray(dirs)))
    got = tsh.eval_sh(deg, t(coeffs), t(dirs)).numpy()
    assert got.shape == (64, 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("deg", [0, 1, 3])
def test_sh_colors_match_jax(deg):
    rng = np.random.RandomState(30 + deg)
    shs = rng.randn(50, 3 * (deg + 1) ** 2).astype(np.float32)
    xyz = (rng.randn(50, 3) * 0.5).astype(np.float32)
    center = np.array([0.3, -0.2, 2.5], np.float32)
    want = np.asarray(jsplat.sh_colors(jnp.asarray(shs), jnp.asarray(xyz),
                                       jnp.asarray(center), deg))
    got = tsplat.sh_colors(t(shs), t(xyz), t(center), deg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # batched over views: (F, N, ...) with one centre a view
    got2 = tsplat.sh_colors(t(np.stack([shs, shs])), t(np.stack([xyz, xyz])),
                            t(np.stack([center, center])), deg)
    np.testing.assert_allclose(got2[1].numpy(), want, atol=1e-6, rtol=0)
    assert (want >= 0).all()


# The JAX package's tests/test_sh.py cases, on the port.

def test_deg0_constant():
    dirs = t(unit_dirs(5, 0))
    out = tsh.eval_sh(0, torch.ones(5, 3, 1), dirs)
    np.testing.assert_allclose(out.numpy(), tsh.C0, atol=1e-6)


def test_rgb_sh_roundtrip():
    rgb = torch.tensor(np.random.RandomState(1).rand(10, 3).astype(np.float32))
    np.testing.assert_allclose(tsh.sh_to_rgb(tsh.rgb_to_sh(rgb)).numpy(), rgb.numpy(),
                               atol=1e-6)


def test_orthogonality_monte_carlo():
    """The degree-3 basis is orthonormal over the sphere (Monte-Carlo,
    loose tolerance)."""
    n = 200000
    dirs = t(unit_dirs(n, 0))

    def basis(i):
        c = torch.zeros(n, 1, 16)
        c[..., i] = 1.0
        return tsh.eval_sh(3, c, dirs)[:, 0].double().numpy()

    b0, b2, b6 = basis(0), basis(2), basis(6)
    sphere = 4 * np.pi
    assert abs(np.mean(b0 * b0) * sphere - 1.0) < 0.05
    assert abs(np.mean(b2 * b2) * sphere - 1.0) < 0.05
    assert abs(np.mean(b6 * b6) * sphere - 1.0) < 0.05
    assert abs(np.mean(b0 * b2) * sphere) < 0.05
    assert abs(np.mean(b2 * b6) * sphere) < 0.05


def test_deg4_runs():
    coeffs = torch.tensor(np.random.RandomState(2).randn(7, 3, 25).astype(np.float32))
    out = tsh.eval_sh(4, coeffs, torch.tensor([[0.0, 0.0, 1.0]] * 7))
    assert out.shape == (7, 3) and torch.isfinite(out).all()


def _blob_cams():
    K = torch.tensor([[[80.0, 0, 32.0], [0, 80.0, 32.0], [0, 0, 1.0]]])
    E1 = torch.eye(4)[None].clone()
    E1[0, 2, 3] = 2.0
    E2 = E1.clone()
    E2[0, :3, :3] = torch.tensor([[-1.0, 0, 0], [0, 1.0, 0], [0, 0, -1.0]])
    return K, E1, E2


def test_sh_color_branch_deg0_matches_rgb_path():
    """The tile splat with sh_degree 0 and RGB2SH coefficients renders the
    RGB path's image."""
    rng = np.random.RandomState(7)
    n = 48
    xyz = t((rng.randn(1, n, 3) * 0.4).astype(np.float32))
    rot = rng.randn(1, n, 4).astype(np.float32)
    rot[..., 0] += 3.0
    s = t(rng.randn(1, n, 3).astype(np.float32) * 0.3)
    o = t(rng.randn(1, n).astype(np.float32))
    c = t(rng.rand(1, n, 3).astype(np.float32) * 0.8 + 0.1)
    K, E, _ = _blob_cams()
    img_rgb = splat_tiles.render_frames(xyz, t(rot), s, o, c, K, E, 64, 64)
    img_sh = splat_tiles.render_frames(xyz, t(rot), s, o, tsh.rgb_to_sh(c), K, E, 64, 64,
                                       sh_degree=0)
    np.testing.assert_allclose(img_sh.numpy(), img_rgb.numpy(), atol=1e-5)


def test_sh_color_branch_deg1_view_dependent():
    """At degree 1 the colour changes with the viewing direction."""
    n = 8
    rng = np.random.RandomState(8)
    xyz = t((rng.randn(1, n, 3) * 0.2).astype(np.float32))
    rot = torch.tensor([[1.0, 0, 0, 0]]).repeat(1, n, 1)
    s, o = torch.full((1, n, 3), 2.0), torch.full((1, n), 4.0)
    shs = t(rng.randn(1, n, 12).astype(np.float32) * 0.3)
    K, E1, E2 = _blob_cams()
    i1 = splat_tiles.render_frames(xyz, rot, s, o, shs, K, E1, 64, 64, sh_degree=1)
    i2 = splat_tiles.render_frames(xyz, rot, s, o, shs, K, E2, 64, 64, sh_degree=1)
    assert torch.isfinite(i1).all() and torch.isfinite(i2).all()
    assert float((i1 - i2).abs().max()) > 1e-3


# --- sparse samplers -------------------------------------------------------

GRID, TILE, C_S = 4, 8, 16


def _sparse_plane(keep, seed):
    """A (grid*tile)^2 sparse plane: the tiles of `keep` covered, slot
    ranks in tile order; two planes (Bq = 2) with their own tiles."""
    rng = np.random.RandomState(seed)
    G2 = GRID * GRID
    slot = np.full(G2, -1, np.int32)
    slot[keep] = np.arange(int(np.sum(keep)))
    tiles = rng.randn(2, int(np.sum(keep)), TILE, TILE, C_S).astype(np.float32)
    pts = (rng.rand(2, 400, 2) * 2.4 - 1.2).astype(np.float32)
    return tiles, np.stack([slot, slot]), pts


COVERAGE = {"full": np.ones(GRID * GRID, bool),
            "partial": np.isin(np.arange(GRID * GRID), [3, 7, 9], invert=True)}


@pytest.mark.parametrize("coverage", ["full", "partial"])
@pytest.mark.parametrize("sampler", ["taps", "slab", "halo"])
def test_sparse_samplers_match_jax(sampler, coverage):
    tiles, slot, pts = _sparse_plane(COVERAGE[coverage], 40)
    res = GRID * TILE
    jt, js, jp = jnp.asarray(tiles), jnp.asarray(slot), jnp.asarray(pts)
    halo = jax.vmap(lambda a, b: jtp.tile_halo(a, b, GRID))
    if sampler == "halo":
        want = jitted(halo, jt, js)
        got = ttp.tile_halo(t(tiles), t(slot).long(), GRID)
    elif sampler == "taps":
        want = jitted(jax.vmap(lambda a, b, p: jtp.grid_sample_2d_sparse(a, b, p, GRID, TILE, res)),
                      jt, js, jp)
        got = ttp.grid_sample_2d_sparse(t(tiles), t(slot), t(pts), GRID, TILE, res)
    else:
        want = jitted(lambda a, b, p: jax.vmap(lambda a, b, p: jtp.grid_sample_2d_sparse_slab(
            a, b, p, GRID, TILE, res))(halo(a, b), b, p), jt, js, jp)
        got = ttp.grid_sample_2d_sparse_slab(ttp.tile_halo(t(tiles), t(slot), GRID), t(slot),
                                             t(pts), GRID, TILE, res)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert np.abs(np.asarray(want)).max() > 0


def test_sample_triplane_sparse_forms_match_jax():
    """sample_triplane_sparse and _slab on one upsampler's SparseTriplanes
    (B = 2): plane order, per-plane slots and the haloed tiles."""
    planes, uv, pts, jsp, params = _sparse_upsampled(3, 2, 10, None)
    sp = load_flax(_port_upsampler(2, 10, None), params)(t(planes), points_uv=t(uv))

    def forms(tiles, slot, valid, pts):     # grid, tile_px and res stay static
        sp = jsp._replace(tiles=tiles, slot=slot, valid=valid)
        th = jax.vmap(jax.vmap(lambda a, b: jtp.tile_halo(a, b, sp.grid)))(tiles, slot)
        return (jtp.sample_triplane_sparse(sp, pts, 1.4),
                jtp.sample_triplane_sparse_slab(sp, th, pts, 1.4))

    want_taps, want_slab = jitted(forms, jsp.tiles, jsp.slot, jsp.valid, jnp.asarray(pts))
    Bn, Pn = sp.tiles.shape[:2]
    tth = ttp.tile_halo(sp.tiles.flatten(0, 1), sp.slot.flatten(0, 1), sp.grid)
    tth = tth.reshape((Bn, Pn) + tth.shape[1:])
    with torch.no_grad():
        got_taps = ttp.sample_triplane_sparse(sp, t(pts), 1.4)
        got_slab = ttp.sample_triplane_sparse_slab(sp, tth, t(pts), 1.4)
    np.testing.assert_allclose(got_taps.numpy(), np.asarray(want_taps), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_slab.numpy(), np.asarray(want_slab), atol=1e-4, rtol=0)
    assert got_taps.shape == (2, pts.shape[1], 3 * 32)


# --- the sparse penultimate level -----------------------------------------

def _sparse_upsampled(seed, num_blocks, cap, pen_cap, tile_px=4, C=32, R=8,
                      spread=False):
    """The JAX sparse upsampler (sparse_final; with pen_cap, the sparse
    penultimate level too) on numpy-seeded planes and body points (spread:
    uniform over the planes, so that every tile is covered), B = 2."""
    rng = np.random.RandomState(seed)
    planes = rng.randn(2, 3, C, R, R).astype(np.float32)
    if spread:
        pts = rng.uniform(-1.4, 1.4, (2, 1500, 3)).astype(np.float32)
    else:
        pts = (rng.randn(2, 200, 3) * np.array([0.25, 0.5, 0.15])).astype(np.float32)
    u = np.clip(pts / 1.4, -1, 1)
    uv = np.stack([np.stack([u[..., a], u[..., b]], -1) for a, b in jtp.PLANE_AXES], 1)
    jmod = jup.TriplaneUpsampler(C, num_blocks, channels_last=True, sparse_final=True,
                                 sparse_max_tiles=cap, sparse_tile_px=tile_px,
                                 sparse_penultimate=pen_cap is not None,
                                 sparse_pen_max_tiles=pen_cap or 128, upconv="poly",
                                 norm_mode="group")
    params = random_params(jmod, seed + 1, jnp.asarray(planes), jnp.asarray(uv))
    sp = jitted(lambda p, x, u: jmod.apply({"params": p}, x, points_uv=u),
                params, jnp.asarray(planes), jnp.asarray(uv))
    return planes, uv, pts, sp, params


def _port_upsampler(num_blocks, cap, pen_cap, tile_px=4, C=32):
    return tup.TriplaneUpsampler(C, num_blocks, sparse_final=True, sparse_max_tiles=cap,
                                 sparse_tile_px=tile_px, norm_mode="group",
                                 sparse_penultimate=pen_cap is not None,
                                 sparse_pen_max_tiles=pen_cap or 128)


@pytest.mark.parametrize("num_blocks,cap,pen_cap", [
    (2, 64, 16),      # full coverage of both levels; the penultimate level is block 0
    (2, 20, 6),       # partial coverage
    (3, 20, 6)])      # partial, one dense level below (the skip projected there)
def test_sparse_penultimate_matches_jax(num_blocks, cap, pen_cap):
    planes, uv, _, want, params = _sparse_upsampled(50 + num_blocks, num_blocks, cap, pen_cap,
                                                    spread=cap == 64)
    with torch.no_grad():
        got = load_flax(_port_upsampler(num_blocks, cap, pen_cap), params)(
            t(planes), points_uv=t(uv))
    for name in ("slot", "valid", "sorted_ids"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    assert (got.grid, got.tile_px, got.res) == (want.grid, want.tile_px, want.res)
    valid = np.asarray(want.valid)
    np.testing.assert_allclose(got.tiles.numpy()[valid], np.asarray(want.tiles)[valid],
                               atol=1e-4, rtol=0)
    assert (cap < got.grid ** 2) == (cap != 64)


# --- the encoder's upsample path ------------------------------------------

def test_triplane_downsampler_matches_jax():
    rng = np.random.RandomState(60)
    planes = rng.randn(2, 3, 32, 24, 24).astype(np.float32)
    jmod = jup.TriplaneDownsampler(32, 3)
    params = random_params(jmod, 61, jnp.asarray(planes))
    want = np.asarray(jitted(lambda p, x: jmod.apply({"params": p}, x), params,
                             jnp.asarray(planes)))
    with torch.no_grad():
        got = load_flax(tup.TriplaneDownsampler(32, 3), params)(t(planes)).numpy()
    assert got.shape == want.shape == (2, 3, 32, 8, 8)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_convnext_block_matches_jax():
    x = np.random.RandomState(62).randn(2, 12, 12, 32).astype(np.float32)
    jmod = jup.ConvNeXtBlock(32)
    params = random_params(jmod, 63, jnp.asarray(x))
    want = np.asarray(jitted(lambda p, x: jmod.apply({"params": p}, x), params,
                             jnp.asarray(x)))
    with torch.no_grad():
        got = load_flax(tup.ConvNeXtBlock(32), params)(t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_scatter_mean_at_96_is_the_jax_mean_bit_for_bit(dtype):
    """The encoder's upsample path scatters at 3R = 96^2 (full width) in
    the point-order segment mean: bit-equal to the JAX segment mean."""
    rng = np.random.RandomState(64)
    vals = rng.randn(1, 4000, 16).astype(np.float32)
    cell = rng.randint(0, 96 * 96, size=(1, 4000))
    cell[0, :700] = 5000                        # one crowded cell
    jv = jnp.asarray(vals).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want = np.asarray(jtp.scatter_mean_plane(jv, jnp.asarray(cell), 96).astype(jnp.float32))
    tv = t(vals).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    got = ttp.scatter_mean_plane(tv, t(cell), 96).float().numpy()
    np.testing.assert_array_equal(got, want)


# --- the tiny serving chunk in each form ----------------------------------

OVERRIDES = dict(num_upsample_blocks=2, max_per_tile=512, upsampler_sparse_max_tiles=3,
                 upsampler_norm="affine", compute_dtype="float32", frames_per_chunk=1,
                 no_point_refiner=True)
FORMS = {"sh_degree_0": dict(rgb=False, sh_degree=0),
         "sh_degree_1": dict(rgb=False, sh_degree=1),
         "no_upsampler": dict(upsample_triplane=False),
         "slab": dict(sample_quad=False, sample_slab=True),
         "taps": dict(sample_quad=False)}
B = 2


def _perturb(params, rng):
    """Visible, varied gaussians and a body kept in view (as
    tests/test_torch_rollout.py)."""
    r = params["triplane_gaussian"]["renderer"]
    for name in ("xyz_layer", "rotation_layer", "scaling_layer", "opacity_layer",
                 "shs_layer"):
        k = r[name]["kernel"]
        r[name]["kernel"] = (k + 1e-2 * rng.randn(*k.shape)).astype(np.float32)
    r["scaling_layer"]["bias"] = np.full(3, 1.5, np.float32)
    r["opacity_layer"]["bias"] = np.full(1, 2.0, np.float32)
    dec = params["triplane_gaussian"]["smplx_triplane_encoder"]["smpl_decoder"]
    dec["transl"]["kernel"] *= 0.01
    dec["transl"]["bias"] *= 0.0
    dec["body_root_pose"]["kernel"] *= 0.01
    dec["body_root_pose"]["bias"] = np.array([1, 0, 0, 0, 1, 0], np.float32)
    params["audio_triplane"]["transformer"]["proj_out"]["kernel"] *= 0.1
    return params


def _form_params(params, form):
    """The chunk's weights for a form: the SH head widened to 3 (deg+1)^2
    (seeded, larger than the RGB head's noise so that the view matters,
    its bias low so that the colours stay below white); without the
    upsampler, its subtree dropped."""
    p = jax.tree_util.tree_map(np.array, params)
    r = p["triplane_gaussian"]["renderer"]
    if not form.get("rgb", True):
        rng = np.random.RandomState(70)
        width = 3 * (form["sh_degree"] + 1) ** 2
        r["shs_layer"] = {"kernel": (0.05 * rng.randn(r["shs_layer"]["kernel"].shape[0], width)
                                     ).astype(np.float32),
                          "bias": (0.3 * rng.randn(width) - 2.0).astype(np.float32)}
    if not form.get("upsample_triplane", True):
        del r["upsampler"]
    return p


@pytest.fixture(scope="module")
def chunk():
    jbody = jsmplx.synthetic_model(seed=0, num_verts=300)
    cfg, model, jchunk = jax_serving_avatar(jbody, **OVERRIDES)
    T_in, T_out = cfg.triplane_input_frames, cfg.triplane_output_frames
    C, L = cfg.triplane_feature_dim, cfg.smpl_token_len
    rng = np.random.RandomState(0)
    tri = rng.randn(B, T_in, C, 3 * cfg.triplane_resolution ** 2).astype(np.float32) * 0.1
    smpl = rng.randn(B, T_in, C, L).astype(np.float32) * 0.1
    audio = rng.randn(B, T_out, cfg.audio_feature_dim).astype(np.float32) * 0.1
    cams = {k: jnp.asarray(v) for k, v in make_batch(B, T_out, cfg.image_size,
                                                      seed=3).cam_parms.items()}
    params = _perturb(random_params(model, 7, tri, smpl, audio, cams,
                                   method=lambda m, *a: jchunk(m, *a, render=False)),
                      np.random.RandomState(8))
    tokens = jax.jit(lambda p, *a: model.apply({"params": p}, *a, render=False,
                                                method=jchunk)).lower(
        params, tri, smpl, audio, cams).compile(compiler_options=FAST_COMPILE)(
        params, tri, smpl, audio, cams)
    return dict(jbody=jbody, tri=tri, smpl=smpl, audio=audio, cams=cams, params=params,
                want=[np.asarray(tokens[1]), np.asarray(tokens[2]),
                      {k: np.asarray(v) for k, v in tokens[3].items()}],
                pred=tokens[3], out_tri=tokens[1])


@pytest.mark.parametrize("form", list(FORMS))
def test_chunk_forms_match_jax(chunk, form):
    over = FORMS[form]
    jbody = chunk["jbody"]
    _, jmodel, _ = jax_serving_avatar(jbody, **OVERRIDES, **over)
    params = _form_params(chunk["params"], over)
    statics = build_renderer_statics(jbody, subdivide_steps=0, densify=True)

    def render(m, tri, cams, pred):
        return m.triplane_gaussian.renderer(statics, tri, cams, pred)[0]

    want = np.asarray(jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a, method=render)).lower(
        params, chunk["out_tri"], chunk["cams"], chunk["pred"]).compile(
        compiler_options=FAST_COMPILE)(params, chunk["out_tri"], chunk["cams"], chunk["pred"]))

    pcfg = serving_config(AvatarConfig.tiny(image_size=(32, 32)), **OVERRIDES, **over)
    port = build_rollout(pcfg, device="cpu", smplx_model=tsmplx.synthetic_model(seed=0,
                                                                                 num_verts=300),
                         state_dict=params_from_flax(params))
    assert hasattr(port.model.renderer, "upsampler") == pcfg.upsample_triplane
    assert port.model.renderer.shs_layer.out_features == (
        3 if pcfg.rgb else 3 * (pcfg.sh_degree + 1) ** 2)
    with torch.no_grad():
        frames, out_tri, out_smpl, pred = port.model.rollout(
            port.statics, t(chunk["tri"]), t(chunk["smpl"]), t(chunk["audio"]),
            {k: t(v) for k, v in chunk["cams"].items()})
    w_tri, w_smpl, w_pred = chunk["want"]
    np.testing.assert_allclose(out_tri.numpy(), w_tri, atol=1e-4, rtol=0)
    np.testing.assert_allclose(out_smpl.numpy(), w_smpl, atol=1e-4, rtol=0)
    for k in w_pred:
        np.testing.assert_allclose(pred[k].numpy(), w_pred[k], atol=1e-4, rtol=0, err_msg=k)
    got = frames.numpy()
    assert got.shape == want.shape == (B, 6, 32, 32, 3)
    diff = np.abs(got - want)
    assert diff.mean() <= 1e-3, diff.mean()
    assert np.isfinite(got).all()
    # not blank: seeded weights move some gaussians out of a few frames
    std = got.reshape(-1, 32 * 32 * 3).std(axis=1)
    assert (std > 0.01).mean() >= 0.5, std

# --- one stage-1 train step in both forms ---------------------------------
# As tests/test_torch_train_stage1.py (the tiny TriplaneGaussianAvatar at
# 32x32, one reference view and three test views, the port's ViT fed the JAX
# ViT's tokens, compiled with the step's options: at XLA's default level the
# ViT compiled alone rounds its bf16 differently), in one configuration that holds both forms: rgb False at SH
# degree 1 (evaluated per view in the reference render and the novel views)
# and the sparse upsampler (tiles of 4 px, 6 of the 16 covered tiles a plane
# kept) sampled by four taps, without the point refiner (its gradients are
# held there). One JAX step, compiled once, serves both forms' cases.

TRAIN_FORM = dict(rgb=False, sh_degree=1, upsampler_sparse=True, upsampler_sparse_tile_px=4,
                  upsampler_sparse_max_tiles=6, no_point_refiner=True)


@pytest.fixture(scope="module")
def step_run():
    """One stage-1 train step of the JAX package and of the port in
    TRAIN_FORM (see the comment above)."""
    jcfg = dataclasses.replace(JaxConfig.tiny(image_size=SIZE), frames_scan_remat=False,
                               **TRAIN_FORM)
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

    cfg = dataclasses.replace(AvatarConfig.tiny(image_size=SIZE), **TRAIN_FORM)
    tr = build_trainer(1, cfg, device="cpu",
                       smplx_model=tsmplx.synthetic_model(seed=0, num_verts=300),
                       state_dict=params_from_flax(params), optim=OptimConfig(**optim))
    flat = torch.tensor(np.asarray(tokens))
    tr.model.sapiens_encoder.forward = lambda images: flat
    got = tr.step(to_device(tmake_batch(1, 1, SIZE, seed=40), "cpu"),
                  to_device(tmake_batch(1, 3, SIZE, seed=41), "cpu"))
    grads = params_from_flax(jax.tree_util.tree_map(np.asarray, new_state.opt_state[1]))
    return dict(tr=tr, got=got, grads=grads,
                metrics={k: float(v) for k, v in metrics.items()})


@pytest.mark.parametrize("views,keys", [
    ("reference", ("loss", "grad_norm", "l1_train", "ssim_train")),
    ("novel", ("l1_test", "ssim_test"))])
def test_train_step_loss_and_grad_norm_match(step_run, views, keys):
    got, want = step_run["got"], step_run["metrics"]
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert want["grad_norm"] > 0


def test_train_step_gradients_match(step_run):
    tr, want = step_run["tr"], step_run["grads"]
    got = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
           for k, p in tr.model.named_parameters() if not k.startswith("sapiens_encoder")}
    leaves_close(got, {k: v for k, v in want.items() if not k.startswith("sapiens_encoder")})


@pytest.mark.parametrize("form", ["sh", "sparse_taps"])
def test_train_step_moves_the_form_parameters(step_run, form):
    """The form's own parameters get a gradient on both sides: the widened
    SH head, or the sparse final level (block 0, its skip projection
    included)."""
    tr, want = step_run["tr"], step_run["grads"]
    own = {"sh": ["renderer.shs_layer.weight"],
           "sparse_taps": ["renderer.upsampler.up_0.res.conv2.weight",
                           "renderer.upsampler.skip_proj.weight"]}[form]
    params = dict(tr.model.named_parameters())
    for k in own:
        assert float(want[k].abs().max()) > 0, k
        assert params[k].grad is not None and float(params[k].grad.abs().max()) > 0, k
    if form == "sh":
        assert params["renderer.shs_layer.weight"].shape[0] == 12
    else:
        assert tr.model.renderer.cfg.upsampler_sparse and not tr.model.renderer.cfg.sample_quad
