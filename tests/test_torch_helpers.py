"""The helper modules no entry point calls: the port against the JAX package.

ops/mesh_utils.py, utils/losses.chamfer_distance, utils/lpips.py (random
weights from a numpy seed carried by weights.convert_subtree, the rule
params_from_flax applies leaf by leaf) and utils/profiling.py's exporter;
with the JAX package's own cases of these modules (tests/test_mesh_utils.py,
test_lpips_smoke) run on the port. The port's tracer has its own tests
(tests/test_torch_tracing.py).

Tolerances: normals, clip coordinates and the Laplacian loss 1e-6, face frames
1e-5 (the same fp32 operations); chamfer 1e-5 relative (sums reassociated);
LPIPS 1e-5 relative (VGG convs reassociated).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_motion_avatar_tpu.ops import mesh_utils as jmesh
from audio_motion_avatar_tpu.utils import losses as jloss
from audio_motion_avatar_tpu.utils.lpips import LPIPS as JaxLPIPS

from audio_motion_avatar_tpu_torch.ops import mesh_utils as M
from audio_motion_avatar_tpu_torch.ops import smplx as tsmplx
from audio_motion_avatar_tpu_torch.utils import lpips as tlpips
from audio_motion_avatar_tpu_torch.utils.losses import chamfer_distance
from audio_motion_avatar_tpu_torch.utils import profiling
from audio_motion_avatar_tpu_torch.utils.profiling import trace
from audio_motion_avatar_tpu_torch.weights import convert_subtree
from torch_parity import one_torch_thread, random_params, t  # noqa: F401

TET_V = torch.tensor([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1.0]])
TET_F = np.asarray([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.int32)


def body():
    m = tsmplx.synthetic_model(seed=0, num_verts=300)
    rng = np.random.RandomState(3)
    verts = (np.asarray(m.v_template)[None] + 0.01 * rng.randn(2, 300, 3)).astype(np.float32)
    return verts, np.asarray(m.faces)


# --- mesh_utils ------------------------------------------------------------

@pytest.mark.parametrize("fn", ["face_normals", "vertex_normals", "face_orientation"])
def test_mesh_geometry_matches_jax(fn):
    verts, faces = body()
    want = getattr(jmesh, fn)(jnp.asarray(verts), faces)
    got = getattr(M, fn)(t(verts), faces)
    if fn == "face_orientation":
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6, rtol=0)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_small_helpers_and_clip_match_jax():
    rng = np.random.RandomState(4)
    x, n = rng.randn(20, 3).astype(np.float32), rng.randn(20, 3).astype(np.float32)
    for name in ("dot", "reflect"):
        np.testing.assert_allclose(getattr(M, name)(t(x), t(n)).numpy(),
                                   np.asarray(getattr(jmesh, name)(jnp.asarray(x),
                                                                   jnp.asarray(n))),
                                   atol=1e-6, rtol=0)
    for name in ("length", "safe_normalize"):
        np.testing.assert_allclose(getattr(M, name)(t(x)).numpy(),
                                   np.asarray(getattr(jmesh, name)(jnp.asarray(x))),
                                   atol=1e-6, rtol=0)
    view, proj = rng.randn(4, 4).astype(np.float32), rng.randn(4, 4).astype(np.float32)
    np.testing.assert_allclose(
        M.clip_from_world(t(x), t(view), t(proj)).numpy(),
        np.asarray(jmesh.clip_from_world(jnp.asarray(x), jnp.asarray(view), jnp.asarray(proj))),
        atol=1e-5, rtol=1e-6)


def test_laplacian_matches_jax():
    verts, faces = body()
    nbr, mask = M.build_laplacian(300, faces)
    jnbr, jmask = jmesh.build_laplacian(300, faces)
    np.testing.assert_array_equal(nbr, jnbr)
    np.testing.assert_array_equal(mask, jmask)
    want = float(jmesh.laplacian_smoothing_loss(jnp.asarray(verts), jnbr, jmask))
    got = float(M.laplacian_smoothing_loss(t(verts), nbr, mask))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_face_normals_direction():
    fn = M.face_normals(TET_V, TET_F).numpy()
    np.testing.assert_allclose(fn[0] / np.linalg.norm(fn[0]), [0, 0, -1], atol=1e-6)


def test_vertex_normals_unit():
    vn = M.vertex_normals(TET_V, TET_F).numpy()
    np.testing.assert_allclose(np.linalg.norm(vn, axis=-1), 1.0, atol=1e-5)


def test_laplacian_zero_for_centroid():
    """A vertex at its neighbours' centroid contributes 0; bumping it raises
    the loss."""
    verts = torch.tensor([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0.5, 0.5, 0.0]])
    faces = np.asarray([[0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4]], np.int32)
    nbr, mask = M.build_laplacian(5, faces)
    bumped = verts.clone()
    bumped[4, 2] = 0.5
    assert float(M.laplacian_smoothing_loss(bumped, nbr, mask)) > \
        float(M.laplacian_smoothing_loss(verts, nbr, mask))


# --- chamfer ---------------------------------------------------------------

@pytest.mark.parametrize("chunk", [64, 2048])
def test_chamfer_matches_jax(chunk):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 300, 3).astype(np.float32)
    y = (rng.randn(2, 170, 3) * 0.8 + 0.1).astype(np.float32)
    want = float(jloss.chamfer_distance(jnp.asarray(x), jnp.asarray(y), chunk=chunk))
    got = float(chamfer_distance(t(x), t(y), chunk=chunk))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_chamfer_identity_and_offset():
    x = torch.tensor(np.random.RandomState(0).randn(1, 100, 3).astype(np.float32))
    assert float(chamfer_distance(x, x)) < 1e-9
    assert float(chamfer_distance(x, x + 0.5)) > 0.01


# --- LPIPS -----------------------------------------------------------------

def test_lpips_matches_jax_on_the_same_weights():
    rng = np.random.RandomState(6)
    a = rng.rand(2, 32, 32, 3).astype(np.float32) * 2 - 1
    b = np.clip(a + 0.3 * rng.randn(*a.shape), -1, 1).astype(np.float32)
    jmod = JaxLPIPS()
    params = random_params(jmod, 7, jnp.asarray(a), jnp.asarray(b))
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(a), jnp.asarray(b)))
    port = tlpips.LPIPS()
    port.load_state_dict(convert_subtree(params), strict=True)
    with torch.no_grad():
        got = port(t(a), t(b)).numpy()
    assert got.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_lpips_loads_a_state_dict(tmp_path):
    """A given path is a torch state dict, read with weights_only=True."""
    src = tlpips.LPIPSLoss()
    tlpips.seeded_init(src.module, seed=3)
    path = tmp_path / "lpips.pt"
    torch.save(src.module.state_dict(), path)
    lp = tlpips.LPIPSLoss(str(path))
    assert lp.pretrained
    a = np.random.RandomState(8).rand(1, 32, 32, 3).astype(np.float32)
    assert float(lp(a, 1 - a)) == float(src(a, 1 - a)) != float(tlpips.LPIPSLoss()(a, 1 - a))


def test_lpips_smoke():
    lp = tlpips.LPIPSLoss()
    a = np.random.RandomState(0).rand(1, 32, 32, 3).astype(np.float32)
    b = np.clip(a + 0.3 * np.random.RandomState(1).randn(1, 32, 32, 3), 0, 1).astype(np.float32)
    assert float(lp(a, a)) < 1e-6
    assert float(lp(a, b)) > 1e-4
    assert not lp.pretrained               # no weights given
    assert float(lp(a, b, bbox=[(4, 4, 16, 16)])) > 1e-4


# --- profiling -------------------------------------------------------------

def test_trace_annotate_and_memory_stats(tmp_path):
    """`trace` writes a profiler trace in which each span of the port's
    tracer is a named range (the annotation), and leaves the tracer off."""
    with trace(str(tmp_path)) as prof:
        with profiling.request("double.request", "cpu"):
            with profiling.span("double"):
                torch.ones(8) * 2
    assert {"double.request", "double"} <= {e.name for e in prof.events()}
    assert any(tmp_path.iterdir())
    assert not profiling.TRACER.on
    (rec,) = [r for r in profiling.records() if r["name"] == "double.request"]
    assert [s["name"] for s in rec["spans"]] == ["double.request", "double"]
    profiling.reset()
