"""Tensor parallelism over the mesh's 'model' axis (parallel/mesh.py,
parallel/tensor.py), the counterpart of tests/test_parallel_tp.py.

- The port's 'model'-sharded parameters, named through weights.py's
  mapping, are exactly the JAX leaves that parallel/mesh.py shards over
  'model' under make_mesh(4, 2) (LOGICAL_RULES applied to the flax axes),
  for the tiny stage-1 model with its point refiner and the stage-2
  serving model.
- Two ranks over a (1, 2) mesh, gloo (tests/torch_ranks.py): one stage-1
  step of the tiny TriplaneGaussianAvatar on test_torch_parallel.py's
  weights and global batch of 2. Each sharded parameter's local shard is
  smaller than the leaf (the others whole), Adam's moments have their
  parameter's shard shape, the step's loss is within the JAX test's
  rtol=2e-4 of the replicated one-process port step and of the JAX loss
  over a (1, 2) mesh with the params sharded by their specs (the step's
  loss is its forward's), and the checkpoint rank 0 writes restores in
  one process to the gathered parameters, bit for bit.
- Every tensor-parallel layer against its whole twin in float32 on the
  same inputs (Transformer1D with its GEGLU halves, with a cross-attention
  to many keys and to one key; the ViT; PTv3; the upsampler with GroupNorm,
  the affine norm and the sparse final level): forward within 2e-6 of the
  output's scale, the gradients of every parameter (gathered) and of the
  inputs within 5e-5 of theirs (float32 sums reassociated by the split
  and the all-reduce).
- shard_state_dict then gather_state_dict is the identity bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_motion_avatar_tpu_torch.models.avatar import TriplaneGaussianAvatar
from audio_motion_avatar_tpu_torch.models.config import AvatarConfig
from audio_motion_avatar_tpu_torch.ops.smplx import synthetic_model
from audio_motion_avatar_tpu_torch.parallel import mesh as pmesh
from audio_motion_avatar_tpu_torch.weights import flax_entries
from torch_parity import one_torch_thread  # noqa: F401
from torch_ranks import start_ranks, wait_ranks

# the 300-vertex synthetic body's vertices and face centres
NVERTS = 300 + int(np.asarray(synthetic_model(seed=0, num_verts=300).faces).shape[0])


def _jax_model_sharded(boxed_params) -> set:
    """The port keys of the JAX leaves sharded over 'model' by make_mesh(4, 2)."""
    from audio_motion_avatar_tpu.parallel import mesh as jmesh
    from jax.sharding import PartitionSpec as P
    mesh = jmesh.make_mesh(num_data=4, num_model=2)
    sh = jmesh.to_named_shardings(mesh, jmesh.logical_specs(boxed_params))
    flags = jax.tree_util.tree_map(
        lambda s: "model" in jax.tree_util.tree_leaves(tuple(s.spec)), sh,
        is_leaf=lambda x: isinstance(x, (jax.sharding.NamedSharding, P)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   jmesh.unbox(boxed_params))
    keys = [key for _, key, _ in flax_entries(zeros)]
    return {k for k, f in zip(keys, jax.tree_util.tree_leaves(flags)) if f}


def _stage1_boxed():
    from audio_motion_avatar_tpu.data.synthetic import make_batch
    from audio_motion_avatar_tpu.models.avatar import TriplaneGaussianAvatar as JaxAvatar
    from audio_motion_avatar_tpu.models.config import AvatarConfig as JaxConfig
    from audio_motion_avatar_tpu.models.ptv3 import build_point_refiner
    from audio_motion_avatar_tpu.models.renderer import build_renderer_statics
    from audio_motion_avatar_tpu.ops import smplx as jsmplx
    jcfg = JaxConfig.tiny(image_size=(32, 32))
    body = jsmplx.synthetic_model(seed=0, num_verts=300)
    statics = build_renderer_statics(body, subdivide_steps=0)
    model = JaxAvatar(cfg=jcfg, num_verts_encoder=NVERTS, point_refiner=build_point_refiner(jcfg))
    ref = make_batch(1, 1, (32, 32), seed=0)
    cam = {k: jnp.asarray(v) for k, v in ref.cam_parms.items()}
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), statics,
                                             jnp.asarray(ref.video), ref.smpl_parms,
                                             cam))["params"]


def _stage2_boxed():
    """The JAX serving model's config and boxed params (one serving chunk,
    test_serving_mesh.py's inputs)."""
    from audio_motion_avatar_tpu.data.synthetic import make_batch
    from audio_motion_avatar_tpu.ops import smplx as jsmplx
    from torch_parity import jax_serving_avatar
    cfg, model, chunk = jax_serving_avatar(jsmplx.synthetic_model(seed=0, num_verts=300))
    T_in, T_out = cfg.triplane_input_frames, cfg.triplane_output_frames
    S = 3 * cfg.triplane_resolution ** 2
    tri = jnp.zeros((2, T_in, cfg.triplane_feature_dim, S))
    smpl = jnp.zeros((2, T_in, cfg.triplane_feature_dim, cfg.smpl_token_len))
    aud = jnp.zeros((2, T_out, cfg.audio_feature_dim))
    cam = {k: jnp.asarray(v) for k, v in make_batch(
        2, T_out, cfg.image_size, seed=3, num_expr=cfg.num_expression_coeffs).cam_parms.items()}
    return cfg, jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), tri, smpl, aud, cam, method=chunk))["params"]


def test_model_sharded_parameters_are_the_jax_set_stage1():
    port = TriplaneGaussianAvatar(AvatarConfig.tiny(image_size=(32, 32)), NVERTS)
    want = _jax_model_sharded(_stage1_boxed())
    got = set(pmesh.model_parallel_table(port))
    assert got == want, (sorted(got - want), sorted(want - got))
    assert any(k.startswith("renderer.point_refiner.") for k in got)
    assert any(k.startswith("sapiens_encoder.") for k in got)
    assert any(".upsampler." in k for k in got)


def test_model_sharded_parameters_are_the_jax_set_serving():
    """The serving chunk's parameters (the audio net, the shared SMPL-X
    decoder, the renderer with its sparse upsampler and refiner)."""
    import dataclasses

    from audio_motion_avatar_tpu.parallel import mesh as jmesh

    from audio_motion_avatar_tpu_torch.models.audio_avatar import AudioDrivenAvatar
    jcfg, boxed = _stage2_boxed()
    want = _jax_model_sharded(boxed)
    names = {f.name for f in dataclasses.fields(AvatarConfig)}
    cfg = AvatarConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in names})
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   jmesh.unbox(boxed))
    chunk_keys = {key for _, key, _ in flax_entries(zeros)}
    got = {k for k in pmesh.model_parallel_table(AudioDrivenAvatar(cfg, NVERTS))
           if k in chunk_keys}
    assert got == want, (sorted(got - want), sorted(want - got))
    assert any(k.startswith("audio_triplane.") for k in got)


@pytest.mark.parametrize("n", [2, 4])
def test_shard_then_gather_is_the_identity(n):
    torch.manual_seed(0)
    model = TriplaneGaussianAvatar(AvatarConfig.tiny(image_size=(32, 32)), NVERTS)
    sd = {k: torch.randn(v.shape) for k, v in model.state_dict().items()}
    table = pmesh.model_parallel_table(model)
    shards = [pmesh.shard_state_dict(sd, table, n, r) for r in range(n)]
    full = pmesh.gather_state_dict(shards, table)
    assert set(full) == set(sd)
    for k, v in sd.items():
        assert torch.equal(full[k], v), k
    k = "fusion_network.transformer_cross.block_0.ff.wi.weight"
    half = sd[k].shape[0] // 2
    m = half // n
    torch.testing.assert_close(shards[1][k], torch.cat([sd[k][m:2 * m], sd[k][half + m:half + 2 * m]]),
                               rtol=0, atol=0)


def test_shard_model_refuses_heads_that_do_not_split():
    from audio_motion_avatar_tpu_torch.models.transformer import Transformer1D
    with pytest.raises(ValueError, match="3 heads do not split over 2"):
        pmesh.shard_model(Transformer1D(1, 3, 8, 32, norm_num_groups=8),
                          pmesh.Mesh(1, 2, model_rank=0, device_mesh=_FakeMesh()))


class _FakeMesh:
    def get_group(self, name):
        return None


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from audio_motion_avatar_tpu.parallel import mesh as jmesh
    from audio_motion_avatar_tpu.training import stage1 as jstage1
    from test_torch_parallel import jax_stage1
    from test_torch_train_stage1 import FAST_COMPILE

    d = tmp_path_factory.mktemp("tp")
    js = jax_stage1(d)
    procs = start_ranks(d, 2, ["tp_stage1", "tp_modules"])
    try:
        import torch_ranks
        one = torch_ranks._stage1_step(str(d), pmesh.Mesh(1, 1))
        one = {k: one[k] for k in ("metrics", "params")}

        # the JAX loss over a (1, 2) mesh, the params sharded by their specs
        model, params = js["model"], js["params"]
        boxed = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *js["init_args"]))
        mesh = jmesh.make_mesh(num_data=1, num_model=2, devices=jax.devices()[:2])
        with jax.set_mesh(mesh):
            psh = jmesh.to_named_shardings(mesh, jmesh.logical_specs(boxed)["params"])
            p = jax.device_put(jax.tree_util.tree_map(jnp.asarray, params), psh)
            ref, test = js["ref"], js["test"]
            loss = jax.jit(lambda p, r, t: jstage1.stage1_loss(
                model, p, js["statics"], r, t, js["cfg"])[0])
            jx_loss = float(loss.lower(p, ref, test).compile(
                compiler_options=FAST_COMPILE)(p, ref, test))
    finally:
        ranks = wait_ranks(d, procs, timeout=600)
    return dict(dir=d, ranks=ranks, one=one, jax_loss=jx_loss)


def test_local_shards_are_smaller_than_the_leaf(runs):
    for r in runs["ranks"]:
        t = r["tp_stage1"]
        assert t["sharded"] and set(t["sharded"]) <= set(t["table"])
        for k, (local, full) in t["shapes"].items():
            if k in t["table"]:
                assert np.prod(local) * 2 == np.prod(full), (k, local, full)
            else:
                assert local == full, k


def test_adam_moments_follow_their_params(runs):
    t = runs["ranks"][0]["tp_stage1"]
    assert len(t["moments"]) == len(t["sharded"]) > 0
    for k, (mu, nu) in t["moments"].items():
        assert mu == nu == t["shapes"][k][0], k


def test_tp_step_loss_matches_replicated_and_jax(runs):
    for r in runs["ranks"]:
        loss = r["tp_stage1"]["metrics"]["loss"]
        np.testing.assert_allclose(loss, runs["one"]["metrics"]["loss"], rtol=2e-4)
        np.testing.assert_allclose(loss, runs["jax_loss"], rtol=2e-4)
        np.testing.assert_allclose(r["tp_stage1"]["metrics"]["grad_norm"],
                                   runs["one"]["metrics"]["grad_norm"], rtol=2e-4)


def test_tp_checkpoint_restores_in_one_process(runs):
    import torch_ranks

    from audio_motion_avatar_tpu_torch.training.checkpoints import CheckpointManager
    inp = torch_ranks._inputs(str(runs["dir"]))
    tr = torch_ranks._trainer(1, inp, None)
    state, ok = CheckpointManager(str(runs["dir"] / "ckpt")).restore(tr.state)
    assert ok and state.step == 1
    got = runs["ranks"][0]["tp_stage1"]["params"]
    for k, p in state.trainable.items():
        assert torch.equal(p.detach(), got[k]), k
    a, b = (r["tp_stage1"]["params"] for r in runs["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("name", ["transformer1d", "transformer1d_one_key", "vit", "ptv3",
                                  "upsampler_group", "upsampler_affine", "upsampler_sparse"])
def test_tp_layers_match_their_whole_twin(runs, name):
    for r in runs["ranks"]:
        fwd, grad, scale, gscale, n_sharded = r["tp_modules"][name]
        assert n_sharded > 0
        assert fwd <= 2e-6 * scale, (fwd, scale)
        assert grad <= 5e-5 * gscale, (grad, gscale)
