"""The port's multi-process runtime and data parallelism (parallel/) against
the one-process port and the JAX package's ('data', 'model') mesh.

Ranks are CPU processes joined over gloo through a file in tmp_path
(tests/torch_ranks.py, one torch thread each); the JAX side runs in this
process on the 8 virtual CPU devices of tests/conftest.py.

- `maybe_initialize` is a no-op without the environment or the config
  (test_parallel_tp.test_maybe_initialize_noop_single_process's
  counterpart); torchrun's and the JAX package's variables map to the rank
  and world; training.multihost without them raises.
- The mesh: training.devices x training.model_parallel shrinks to the
  world as the JAX trainer shrinks to its devices.
- One stage-1 step of the tiny TriplaneGaussianAvatar (AvatarConfig.tiny
  at 32x32 with its point refiner, the 300-vertex synthetic SMPL-X, the
  visible JAX weights of test_torch_train_stage1.py, a global batch of 2)
  over a (2, 1) mesh of two ranks, each on its row: loss and grad_norm
  within 1e-4 relative of the one-process port step on the whole batch and
  of the JAX step on a (2, 1) mesh; every gradient leaf within 1e-3 of
  its norm (above test_torch_train_stage1.py's noise floor) of the JAX
  step's and within 1e-2 of the one-process step's (one ReLU kink, see
  the test); every updated parameter within test_torch_train_stage1.py's
  params_close bounds of both; both ranks hold the same parameters.
- Three stage-2 steps at cache_replacement_prob 1.0 (batch ids 0, 12, 24,
  so the second and third steps read the cache at depth 1 and 2) over two
  ranks against the one-process fit, seeded weights, learning rate 1e-5:
  losses and grad_norm within 1e-4 relative, the same cache depth a step,
  and the same cache entries row for row within 1e-5 of their scale. (Adam's
  first update moves every element by the learning rate whatever its
  gradient's size, so where a gradient element is rounding noise the two
  runs move it apart by up to twice the rate; at 1e-3 that took the third
  step's loss 0.4% apart.)
- main2 --mode train with training.devices=2 over two ranks writes one
  event file and one checkpoint, from rank 0; the checkpoint restores in
  one process.
- The data ranks' reader: items g B + rank + k n of global batch g, the
  global batch's id, read through the prefetch ring in order.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_motion_avatar_tpu_torch.data.factory import DataRankItems
from audio_motion_avatar_tpu_torch.data.prefetch import NativePrefetcher
from audio_motion_avatar_tpu_torch.parallel import distributed
from audio_motion_avatar_tpu_torch.parallel import mesh as pmesh
from audio_motion_avatar_tpu_torch.training.stage2 import PredictionCache
from torch_parity import one_torch_thread, random_params  # noqa: F401
from torch_ranks import TINY_YAML, start_ranks, wait_ranks

SIZE = (32, 32)
LR = 1e-3
OPTIM = dict(learning_rate=LR, total_steps=100)


# ---------------------------------------------------------------------------
# runtime
# ---------------------------------------------------------------------------

def test_maybe_initialize_noop_single_process(monkeypatch):
    for k in ("AMA_MULTIHOST", "JAX_COORDINATOR_ADDRESS", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.maybe_initialize(None) is False

    class _Cfg:
        class training:
            @staticmethod
            def get(k, d=None):
                return d
    assert distributed.maybe_initialize(_Cfg) is False
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("env,want", [
    ({"WORLD_SIZE": "4", "RANK": "3", "LOCAL_RANK": "1", "MASTER_ADDR": "h",
      "MASTER_PORT": "29500"}, distributed.Rendezvous("env://", 4, 3, 1)),
    ({"JAX_COORDINATOR_ADDRESS": "10.0.0.2:1234", "JAX_NUM_PROCESSES": "8",
      "JAX_PROCESS_ID": "5"}, distributed.Rendezvous("tcp://10.0.0.2:1234", 8, 5, None)),
    ({"AMA_MULTIHOST": "1", "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
      "MASTER_ADDR": "localhost", "MASTER_PORT": "1"},
     distributed.Rendezvous("env://", 1, 0, 0)),
    ({"WORLD_SIZE": "1", "RANK": "0"}, None),
], ids=["torchrun", "jax-variables", "multihost-world-1", "torchrun-one-process"])
def test_rendezvous_reads_the_environment(env, want):
    assert distributed.rendezvous(None, env) == want


def test_multihost_without_addresses_raises():
    cfg = {"training": {"multihost": True}}
    with pytest.raises(ValueError, match="JAX_COORDINATOR_ADDRESS"):
        distributed.rendezvous(cfg, {})
    assert distributed.rendezvous({"training": {"multihost": False}}, {}) is None


def test_bound_device_is_local_rank_or_named():
    rdv = distributed.Rendezvous("env://", 2, 1, 1)
    assert distributed.bound_device(rdv, "cpu") == torch.device("cpu")
    assert distributed.bound_device(rdv, "cuda:0") == torch.device("cuda", 0)


@pytest.mark.parametrize("devices,model_parallel", [(1, 1), (2, 1), (1, 2), (4, 2)])
def test_mesh_shrinks_to_the_world_as_the_jax_trainer(devices, model_parallel):
    """The JAX trainer's rule (trainer.py:137-144) with the world (here one
    process) in place of its devices."""
    avail = 1
    n_data, n_model = devices, model_parallel
    if n_data * n_model > avail:
        n_data, n_model = avail, 1
    mesh = pmesh.mesh_from_config({"training": {"devices": devices,
                                                "model_parallel": model_parallel}})
    assert (mesh.num_data, mesh.num_model) == (n_data, n_model) == (1, 1)


def test_mesh_refuses_a_product_that_is_not_the_world():
    with pytest.raises(ValueError, match="needs 4 processes"):
        pmesh.make_mesh(2, 2)


# ---------------------------------------------------------------------------
# the data ranks' reader and the cache merge (in this process)
# ---------------------------------------------------------------------------

class _Items:
    def __len__(self):
        return 9

    def __getitem__(self, i):
        return f"ref{i}", f"tgt{i}", i


def test_data_rank_items_read_their_rows_of_each_global_batch():
    views = [DataRankItems(_Items(), 4, r, 2) for r in range(2)]
    assert [len(v) for v in views] == [4, 4]
    assert [views[0][j] for j in range(4)] == [
        ("ref0", "tgt0", 0), ("ref2", "tgt2", 0), ("ref4", "tgt4", 4), ("ref6", "tgt6", 4)]
    assert [views[1][j][2] for j in range(4)] == [0, 0, 4, 4]
    ordered = NativePrefetcher(views[1], num_workers=3, capacity=2, ordered=True)
    assert [item[0] for item in ordered] == ["ref1", "ref3", "ref5", "ref7"]


def test_cache_merge_keeps_every_rank_row_in_global_order():
    cache = PredictionCache(1.0)
    rows = [torch.arange(12.).reshape(2, 6) + 100 * r for r in range(2)]    # 2 rows a rank
    gathered = [{(0, 12): {"triplane": rows[r], "smplx_tokens": -rows[r], "iter": 1}}
                for r in range(2)]
    cache.merge(gathered)
    item = cache.store[(0, 12)]
    torch.testing.assert_close(item["triplane"], torch.stack(
        [rows[0][0], rows[1][0], rows[0][1], rows[1][1]]), rtol=0, atol=0)
    assert item["iter"] == 1
    mesh = pmesh.Mesh(2, 1, data_rank=1)
    torch.testing.assert_close(pmesh.rows(item["triplane"], mesh), rows[1], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the two-rank runs
# ---------------------------------------------------------------------------

def _jax(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


def jax_stage1(d):
    """The tiny JAX stage-1 model with its point refiner, visible seeded
    weights (test_torch_train_stage1.py's), a global batch of 2 (one
    reference view, two test views a row) and the JAX ViT's image tokens of
    it; the port's inputs written to d/inputs.pt for the ranks."""
    import dataclasses

    from audio_motion_avatar_tpu.data.synthetic import make_batch as jmake_batch
    from audio_motion_avatar_tpu.models.avatar import TriplaneGaussianAvatar as JaxAvatar
    from audio_motion_avatar_tpu.models.config import AvatarConfig as JaxConfig
    from audio_motion_avatar_tpu.models.ptv3 import build_point_refiner as jbuild_refiner
    from audio_motion_avatar_tpu.models.renderer import build_renderer_statics as jstatics
    from audio_motion_avatar_tpu.ops import smplx as jsmplx
    from test_torch_train_stage1 import visible

    from audio_motion_avatar_tpu_torch.weights import params_from_flax

    jcfg = dataclasses.replace(JaxConfig.tiny(image_size=SIZE), frames_scan_remat=False)
    jmodel = jsmplx.synthetic_model(seed=0, num_verts=300)
    statics = jstatics(jmodel, subdivide_steps=jcfg.subdivide_steps,
                       densify=jcfg.densify_smplx_verts)
    nverts = 300 + np.asarray(jmodel.faces).shape[0]
    model = JaxAvatar(cfg=jcfg, num_verts_encoder=nverts, point_refiner=jbuild_refiner(jcfg))
    ref, test = jmake_batch(2, 1, SIZE, seed=40), jmake_batch(2, 2, SIZE, seed=41)
    jref, jtest = _jax(ref), _jax(test)
    init_args = (statics, jref.video, jref.smpl_parms, jref.cam_parms)
    params = visible(random_params(model, 42, *init_args))
    tokens = jax.jit(lambda p, v: model.apply(
        {"params": p}, v, method=lambda m, x: m.sapiens_encoder(x.reshape((-1,) + x.shape[2:]))))(
        jax.tree_util.tree_map(jnp.asarray, params), jref.video)
    torch.save(dict(state_dict=params_from_flax(params),
                    tokens=torch.tensor(np.asarray(tokens)),
                    optim=OPTIM, ref=(2, 1), ref_seed=40, test=(2, 2), test_seed=41),
               d / "inputs.pt")
    return dict(cfg=jcfg, model=model, statics=statics, params=params, ref=jref,
                test=jtest, init_args=init_args)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX (2, 1) step and its weights; two ranks running the DP step,
    the stage-2 fit and the CLI; the one-process port steps here."""
    from audio_motion_avatar_tpu.parallel import mesh as jmesh
    from audio_motion_avatar_tpu.training import stage1 as jstage1
    from audio_motion_avatar_tpu.training import train_state as jts
    from test_torch_train_stage1 import FAST_COMPILE, recording

    from audio_motion_avatar_tpu_torch.weights import params_from_flax

    d = tmp_path_factory.mktemp("dp")
    s2 = d / "stage2_one"
    s2.mkdir()
    js = jax_stage1(d)
    model, statics, jcfg, params = js["model"], js["statics"], js["cfg"], js["params"]
    jref, jtest = js["ref"], js["test"]
    torch.save(dict(optim=OPTIM), s2 / "inputs.pt")
    procs = start_ranks(d, 2, ["dp_stage1", "stage2_fit", "cli_train"])
    one_s2 = start_ranks(s2, 1, ["stage2_fit"])
    try:
        # the one-process port step on the whole batch
        import torch_ranks
        one = torch_ranks._stage1_step(str(d), pmesh.Mesh(1, 1))
        one = {k: one[k] for k in ("metrics", "params", "grads")}

        # the JAX step over a (2, 1) mesh, the batch sharded over 'data'
        state = jts.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                                      recording(jts.make_optimizer(jts.OptimConfig(**OPTIM))))
        step = jstage1.make_train_step(model, statics, jcfg, with_test_views=True,
                                       donate=False)
        mesh = jmesh.make_mesh(num_data=2, num_model=1, devices=jax.devices()[:2])
        with jax.set_mesh(mesh):
            state = jax.device_put(state, jmesh.replicated(mesh))
            bsh = jmesh.batch_sharding(mesh)
            jref, jtest = jax.device_put(jref, bsh), jax.device_put(jtest, bsh)
            new_state, metrics = step.lower(state, jref, jtest).compile(
                compiler_options=FAST_COMPILE)(state, jref, jtest)
        np_ = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
        jx = dict(metrics={k: float(v) for k, v in metrics.items()},
                  grads=params_from_flax(np_(new_state.opt_state[1])),
                  params=params_from_flax(np_(new_state.params)))
    finally:
        ranks = wait_ranks(d, procs, timeout=600)
        one_s2 = wait_ranks(s2, one_s2, timeout=600)[0]["stage2_fit"]
    return dict(dir=d, ranks=ranks, one=one, jax=jx, one_s2=one_s2)


def _trainable(tree):
    return {k: v for k, v in tree.items() if not k.startswith("sapiens_encoder")}


def test_dp_step_loss_and_grad_norm_match_one_process_and_jax(runs):
    for r in runs["ranks"]:
        got = r["dp_stage1"]["metrics"]
        for want in (runs["one"]["metrics"], runs["jax"]["metrics"]):
            for k in ("loss", "grad_norm", "l1_train", "l1_test", "ssim_train", "ssim_test",
                      "smplx_param_loss"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert runs["jax"]["metrics"]["grad_norm"] > 0


def test_dp_step_gradients_match_one_process_and_jax(runs):
    """Every leaf within 1e-3 of the JAX (2, 1) step's (they agree within
    3e-5). Against the one-process port step on the whole batch within
    1e-2: a float32 product over 2 rows rounds differently from one over 1
    (about 1e-6 of the point refiner's output here), and one ReLU of
    refine_mlp whose input sits that close to 0 for one point of this batch
    passes its gradient in one run and not in the other; that point's
    gradient moves the refiner's leaves by up to 0.85% and the leaves
    upstream of it (the encoders) by up to 0.34%."""
    from test_torch_train_stage1 import leaves_close
    got = _trainable(runs["ranks"][0]["dp_stage1"]["grads"])
    leaves_close(got, _trainable(runs["jax"]["grads"]))
    leaves_close(got, _trainable(runs["one"]["grads"]), rel=1e-2)


def test_dp_step_updated_parameters_match(runs):
    from test_torch_train_stage1 import params_close
    r0, r1 = (r["dp_stage1"] for r in runs["ranks"])
    for k in r0["params"]:
        assert torch.equal(r0["params"][k], r1["params"][k]), k
    for want, grads in ((runs["one"], runs["one"]["grads"]), (runs["jax"], runs["jax"]["grads"])):
        params_close(r0["params"], _trainable(grads), _trainable(want["params"]), lr=LR)


def test_stage2_fit_with_cache_sync_matches_one_process(runs):
    one = runs["one_s2"]
    for r in runs["ranks"]:
        got = r["stage2_fit"]
        assert [s["cache_iter"] for s in got["steps"]] == \
            [s["cache_iter"] for s in one["steps"]] == [0.0, 1.0, 2.0]
        for a, b in zip(got["steps"], one["steps"]):
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4)
        assert set(got["store"]) == set(one["store"]) == {(0, 12), (0, 24), (0, 36)}
        for key in one["store"]:
            for name in ("triplane", "smplx_tokens"):
                a, b = got["store"][key][name], one["store"][key][name]
                assert a.shape == b.shape and a.shape[0] == 2
                scale = float(b.abs().max())
                assert float((a - b).abs().max()) <= 1e-5 * scale, (key, name)
            assert got["store"][key]["iter"] == one["store"][key]["iter"]
    a, b = (r["stage2_fit"]["store"] for r in runs["ranks"])
    assert all(torch.equal(a[k]["triplane"], b[k]["triplane"]) for k in a)


def test_main2_train_over_two_ranks_writes_once_from_rank_0(runs):
    from audio_motion_avatar_tpu_torch import main2
    from audio_motion_avatar_tpu_torch.configs import ConfigLoader
    from audio_motion_avatar_tpu_torch.configs.build import build_avatar_config
    from audio_motion_avatar_tpu_torch.training.checkpoints import CheckpointManager
    out = runs["dir"] / "cli"
    events = os.listdir(out / "tb")
    assert len(events) == 1 and events[0].startswith("events.out.tfevents"), events
    assert sorted(os.listdir(out / "checkpoints")) == ["2"]
    assert len(os.listdir(out / "audio_rendered_images")) == 2
    s0, s1 = (r["cli_train"]["steps"] for r in runs["ranks"])
    assert [s["metrics"]["loss"] for s in s0] == [s["metrics"]["loss"] for s in s1]
    # the checkpoint restores in one process
    cfg = ConfigLoader.load_config(TINY_YAML, [])
    rollout = main2.build_stage2(cfg, build_avatar_config(cfg), "cpu")
    state = main2.init_state2(rollout.model, cfg)
    state, ok = CheckpointManager(str(out / "checkpoints")).restore(state)
    assert ok and state.step == 2


def test_factory_reads_rank_rows_of_the_global_batch(tmp_path):
    """The train split's loader over a (2, 1) mesh: each rank's row of the
    synthetic global batch, the global batch's id."""
    from audio_motion_avatar_tpu_torch.configs import ConfigLoader
    from audio_motion_avatar_tpu_torch.data.factory import DatasetFactory
    cfg = ConfigLoader.load_config(TINY_YAML, ["training.batch_size=2", "dataset.length=2"])
    whole = list(DatasetFactory.create_dataloader(cfg, "train"))
    for r in range(2):
        part = list(DatasetFactory.create_dataloader(cfg, "train",
                                                     mesh=pmesh.Mesh(2, 1, data_rank=r)))
        assert [b[2] for b in part] == [b[2] for b in whole]
        for (ref, tgt, _), (wref, wtgt, _) in zip(part, whole):
            np.testing.assert_array_equal(ref.video, wref.video[r::2])
            np.testing.assert_array_equal(tgt.audio_features, wtgt.audio_features[r::2])


@pytest.mark.parametrize("extra", [["training.devices=2"], ["training.model_parallel=2"]],
                         ids=["devices", "model_parallel"])
def test_main_parallel_options_run_in_one_process(extra, tmp_path, capsys):
    """A one-process run asked for more devices shrinks its mesh to (1, 1),
    as the JAX trainer does with the devices it finds, and trains."""
    from audio_motion_avatar_tpu_torch import main
    main.main(["--device", "cpu", "--config", TINY_YAML, "--mode", "train",
               f"training.output_dir={tmp_path}", *extra])
    out = capsys.readouterr().out
    assert "[mesh] ('data', 'model') = (1, 1) over 1 process" in out
    assert "[main] done." in out

