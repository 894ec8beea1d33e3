"""The port's training loop against the JAX package's (training/trainer.py)
and its optimizer against optax.adamw.

1. AdamW: `Optimizer` with weight_decay > 0 against the JAX chain
   (`make_optimizer`: clip_by_global_norm, then optax.adamw, inside
   apply_if_finite and MultiSteps), five updates of seeded leaves with
   gradients far above the clip, at accumulate 1 and 4: parameters within
   1e-6 after every micro-step (both float32).
2. The event files: `MetricLogger`'s files read back by tensorboard's
   EventAccumulator and by `read_scalars`.
3. `Trainer` bookkeeping: the JAX Trainer and the port's driven by the same
   stub steps (plain Python returning metrics) over the same batches, three
   epochs with accumulation 2, logging every 2 steps, validation each epoch
   and top-2 checkpoints: the same printed lines (step_time_s masked), the
   same scalars in the event files (step_time_s left out), the same
   learning rates at every step, the same checkpoint steps kept, the same
   best_metric and the same comparison PNG.
4. `Trainer.validate` on config_tiny.yaml's synthetic val split with the
   same weights (weights.params_from_flax): the JAX eval step (compiled at
   XLA's lowest optimisation level) against the port's on the CPU, every
   averaged metric within 1e-4 relative. The port's ViT returns the image
   tokens of the JAX ViT compiled alone (the ViT runs in bf16 on both sides
   and rounds differently).
"""

import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image
from torch import nn

import jax
import jax.numpy as jnp
import optax

from audio_motion_avatar_tpu.configs.loader import Config as JaxConfig
from audio_motion_avatar_tpu.configs.loader import ConfigLoader as JaxLoader
from audio_motion_avatar_tpu.training import train_state as jts
from audio_motion_avatar_tpu.training.trainer import Trainer as JaxTrainer

from audio_motion_avatar_tpu_torch.configs.loader import Config, ConfigLoader
from audio_motion_avatar_tpu_torch.data.synthetic import make_batch
from audio_motion_avatar_tpu_torch.training import train_state as tts
from audio_motion_avatar_tpu_torch.training.trainer import (MetricLogger, Trainer,
                                                             read_scalars)
from torch_parity import one_torch_thread, random_params  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


# ---------------------------------------------------------------------------
# 1. AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accumulate", [1, 4])
def test_adamw_matches_optax(accumulate):
    kw = dict(learning_rate=1e-2, total_steps=10, end_factor=0.1, weight_decay=0.05,
              grad_clip=1.0, accumulate_steps=accumulate)
    rng = np.random.RandomState(3)
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    tx = jts.make_optimizer(jts.OptimConfig(**kw))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = tx.init(jp)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    opt = tts.Optimizer(tts.OptimConfig(**kw), tp)
    for i in range(5 * accumulate):
        g = {k: (rng.randn(*s) * (2.0 if i % 2 else 0.01)).astype(np.float32)
             for k, s in SHAPES.items()}
        updates, jstate = update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt.apply({k: torch.tensor(v) for k, v in g.items()}, tp)
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6,
                                       err_msg=f"micro-step {i} {k}")
    assert opt.count == 5


# ---------------------------------------------------------------------------
# 2. event files
# ---------------------------------------------------------------------------

def _accumulated(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    acc = EventAccumulator(str(log_dir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_event_files_read_back_by_tensorboard(tmp_path):
    logger = MetricLogger(str(tmp_path / "tb"))
    logged = {0: {"loss": 1.5, "lr": 1e-4}, 7: {"loss": 0.25, "lr": 5e-5},
              300: {"loss": float("nan"), "lr": 0.0}}
    for step, metrics in logged.items():
        logger.log(step, metrics, "train")
    logger.log(300, {"loss_total": 0.125}, "val")
    logger.close()
    files = list((tmp_path / "tb").iterdir())
    assert len(files) == 1 and files[0].name.startswith("events.out.tfevents.")
    got = _accumulated(tmp_path / "tb")
    assert sorted(got) == ["train/loss", "train/lr", "val/loss_total"]
    want_lr = [(s, float(np.float32(m["lr"]))) for s, m in logged.items()]
    assert got["train/lr"] == want_lr
    assert got["train/loss"][:2] == [(0, 1.5), (7, 0.25)] and np.isnan(got["train/loss"][2][1])
    assert got["val/loss_total"] == [(300, 0.125)]
    scalars = read_scalars(str(files[0]))
    assert [(s, t) for s, t, _ in scalars] == [
        (0, "train/loss"), (0, "train/lr"), (7, "train/loss"), (7, "train/lr"),
        (300, "train/loss"), (300, "train/lr"), (300, "val/loss_total")]
    assert scalars[1][2] == np.float32(1e-4)


def test_wandb_request_falls_back_to_event_files(tmp_path, capsys):
    logger = MetricLogger(str(tmp_path / "tb"), use_wandb=True)
    logger.log(1, {"x": 2.0})
    logger.close()
    assert "falling back to TB" in capsys.readouterr().out
    assert _accumulated(tmp_path / "tb") == {"train/x": [(1, 2.0)]}
    assert MetricLogger(str(tmp_path / "none"), use_tb=False).writer is None


# ---------------------------------------------------------------------------
# 3. the JAX Trainer and the port's driven by the same stub steps
# ---------------------------------------------------------------------------

def _training(out):
    return {"max_epochs": 3, "fast_dev_run": False, "output_dir": str(out),
            "learning_rate": 1e-3, "total_steps": 6, "gradient_accumulate_steps": 2,
            "gradient_clip_val": 1.0, "scheduler": {"end_factor": 0.1},
            "optimizer": {"betas": [0.9, 0.999], "weight_decay": 0.0},
            "logging": {"log_every_n_steps": 2},
            "validation": {"monitor": "val/loss_total", "save_top_k": 2,
                           "val_every_n_epoch": 1},
            "devices": 1, "model_parallel": 1}


class Stubs:
    """Seeded metrics a call; the eval losses make epoch 2 the best."""

    VAL = (0.5, 0.2, 0.4)

    def __init__(self):
        self.n_train = self.n_eval = 0
        self.rng = np.random.RandomState(5)
        self.frames = self.rng.rand(1, 2, 8, 6, 3).astype(np.float32)

    def train(self, state, ref, test):
        n = self.n_train = self.n_train + 1
        return state, {"loss": 1.0 / n, "grad_norm": 0.5 + 0.25 * (n % 3)}

    def eval(self, ref, test):
        epoch = self.n_eval // 2
        self.n_eval += 1
        return {"loss": self.VAL[epoch], "l1_test": 0.1 * epoch}

    def render(self, ref):
        return self.frames, self.frames[..., ::-1]


def _run(trainer_cls, cfg, state, stubs, jax_side, data, val):
    if jax_side:
        tr = trainer_cls(cfg, stubs.train, lambda params, r, t: stubs.eval(r, t),
                         render_fn=lambda params, r: stubs.render(r))
    else:
        tr = trainer_cls(cfg, stubs.train, stubs.eval, render_fn=stubs.render, device="cpu")
    tr.fit(state, data, val)
    return tr


def test_trainer_bookkeeping_matches_jax(tmp_path, capsys):
    from audio_motion_avatar_tpu.data.synthetic import make_batch as jmake_batch
    jdata = [(jmake_batch(1, 1, (8, 6), seed=i), jmake_batch(1, 2, (8, 6), seed=10 + i), i)
             for i in range(5)]
    tdata = [(make_batch(1, 1, (8, 6), seed=i), make_batch(1, 2, (8, 6), seed=10 + i), i)
             for i in range(5)]
    jstate = jts.TrainState.create({"w": jnp.zeros(3)}, jts.make_optimizer(jts.OptimConfig()))
    tstate = tts.TrainState(nn.Linear(3, 1), tts.OptimConfig())

    jtr = _run(JaxTrainer, JaxConfig.wrap({"training": _training(tmp_path / "jax")}),
               jstate, Stubs(), True, jdata, jdata[:2])
    jlines = capsys.readouterr().out
    ttr = _run(Trainer, Config.wrap({"training": _training(tmp_path / "port")}),
               tstate, Stubs(), False, tdata, tdata[:2])
    tlines = capsys.readouterr().out

    def log_lines(text):
        return [re.sub(r"step_time_s=\S+", "step_time_s=*", ln) for ln in text.splitlines()
                if ln.startswith("[e")]

    assert log_lines(tlines) == log_lines(jlines) and len(log_lines(tlines)) == 8
    steps = range(16)
    assert [ttr.learning_rate(s) for s in steps] == \
        [float(jtr._lr_schedule(s // jtr._lr_accum)) for s in steps]
    assert sorted(ttr.ckpt.all_steps()) == sorted(jtr.ckpt._mgr.all_steps()) == [10, 15]
    assert ttr.best_metric == jtr.best_metric == 0.2

    def scalars(out):
        return {k: v for k, v in _accumulated(out / "tb").items() if "step_time_s" not in k}

    got, want = scalars(tmp_path / "port"), scalars(tmp_path / "jax")
    assert got == want and {"train/lr", "val/loss_total", "val/l1_test"} <= set(got)
    png = "train_images/comparison_0.png"
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / png)),
                                  np.asarray(Image.open(tmp_path / "jax" / png)))


def test_trainer_refuses_parallel_configs():
    for key in ("devices", "model_parallel"):
        cfg = Config.wrap({"training": {key: 2, "fast_dev_run": True}})
        with pytest.raises(NotImplementedError, match="item 7"):
            Trainer(cfg, None, None, device="cpu")


# ---------------------------------------------------------------------------
# 4. Trainer.validate against the JAX one
# ---------------------------------------------------------------------------

def _visible(params):
    """Larger, more opaque gaussians and a tamed refiner, so that the
    renders are not blank."""
    r = params["renderer"]
    r["scaling_layer"]["bias"] = np.full(3, 1.5, np.float32)
    r["opacity_layer"]["bias"] = np.full(1, 2.0, np.float32)
    for name in ("xyz_layer", "rotation_layer", "scaling_layer", "opacity_layer", "shs_layer"):
        r[name]["kernel"] = (r[name]["kernel"] * 0.1).astype(np.float32)
    r["refine_mlp"]["layers_4"]["kernel"] *= 0.01
    return params


def test_validate_matches_jax(tmp_path):
    from audio_motion_avatar_tpu import main as jmain
    from audio_motion_avatar_tpu.data.factory import DatasetFactory as JaxFactory
    from audio_motion_avatar_tpu.training import stage1 as jstage1

    from audio_motion_avatar_tpu_torch import main as tmain
    from audio_motion_avatar_tpu_torch.data.factory import DatasetFactory
    from audio_motion_avatar_tpu_torch.training import stage1
    from audio_motion_avatar_tpu_torch.weights import params_from_flax

    over = ["dataset.image_size=[32,32]", "dataset.length=2",
            f"training.output_dir={tmp_path}", "training.fast_dev_run=false"]
    jcfg = JaxLoader.load_config(str(ROOT / "audio_motion_avatar_tpu/configs/config_tiny.yaml"),
                                 over)
    model, statics, ac = jmain.build_everything(jcfg)
    jval = list(JaxFactory.create_dataloader(jcfg, "val"))
    ref0 = jax.tree_util.tree_map(jnp.asarray, jval[0][0])
    params = _visible(random_params(model, 11, statics, ref0.video, ref0.smpl_parms,
                                    ref0.cam_parms))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    jeval = jstage1.make_eval_step(model, statics, ac)
    jtest0 = jax.tree_util.tree_map(jnp.asarray, jval[0][1])
    compiled = jeval.lower(params, ref0, jtest0).compile(compiler_options=FAST_COMPILE)
    jtr = JaxTrainer(jcfg, None, lambda p, r, t: compiled(p, r, t))
    want = jtr.validate(types.SimpleNamespace(params=params), jval)
    vit = jax.jit(lambda p, v: model.apply(
        {"params": p}, v, method=lambda m, x: m.sapiens_encoder(x.reshape((-1,) + x.shape[2:]))))
    tokens = [torch.tensor(np.asarray(vit(params, jnp.asarray(r.video)))) for r, _, _ in jval]

    cfg = ConfigLoader.load_config(str(ROOT / "audio_motion_avatar_tpu_torch/configs/config_tiny.yaml"),
                                   over)
    tmodel, tstatics, tac = tmain.build_everything(cfg, "cpu")
    tmodel.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)),
                           strict=True)
    queue = list(tokens)
    tmodel.sapiens_encoder.forward = lambda images: queue.pop(0)
    val = list(DatasetFactory.create_dataloader(cfg, "val", "cpu"))
    for (r, t, _), (jr, jt, _) in zip(val, jval):
        np.testing.assert_array_equal(r.video, jr.video)
        np.testing.assert_array_equal(t.video, jt.video)
    ttr = Trainer(cfg, None, stage1.make_eval_step(tmodel, tstatics, tac), device="cpu")
    got = ttr.validate(tmain.init_state(tmodel, cfg), val)
    assert not queue and len(val) == 2
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * max(abs(want[k]), 1e-3), (k, got[k], want[k])
    assert want["opacity_act_mean"] > 0.5     # the gaussians are visible
