"""Training orchestration (the JAX package's training/trainer.py).

`Trainer` runs the epoch loop around a train step: logging every
log_every_n_steps (the metrics read back to the host, then step_time_s and
the learning rate of the schedule at global_step // accumulate), a
rendered-vs-target comparison PNG every 500 steps, validation every
val_every_n_epoch epochs followed by a checkpoint kept by the monitored
metric (save_top_k), or a checkpoint at the end of each epoch without
validation data; fast_dev_run runs one batch of one epoch, without event
files or checkpoints. The steps are the port's: train_step(state, ref,
test) -> (state, metrics), eval_step(ref, test) -> metrics and
render_fn(ref) -> (rendered, target), the model closed over (as
training/stage1.py builds them); batches arrive as numpy VideoBatch items
and move to the trainer's device.

`MetricLogger` writes TensorBoard scalar event files itself (TFRecord
framing with masked CRC-32C, each Event encoded by hand as protobuf), so
the logs exist where tensorboard is not installed; `read_scalars` reads
them back. A request for wandb falls back to the event files, as the JAX
logger does when wandb is missing.

The JAX trainer shrinks its device mesh to the devices it finds; the port
has one device a process and refuses training.devices > 1 or
training.model_parallel > 1 rather than let one card stand in for several.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..data.synthetic import to_device
from ..device import resolve_device
from ..utils.video import encode_png, to_uint8
from .checkpoints import CheckpointManager
from .train_state import _linear

PARALLEL_ITEM = "ROADMAP.md section 1 item 7 (parallelism)"
FILE_VERSION = b"brain.Event:2"


# ---------------------------------------------------------------------------
# TensorBoard event files
# ---------------------------------------------------------------------------

def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as TFRecord frames use it."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _field(number: int, wire: int, payload: bytes) -> bytes:
    return _varint(number << 3 | wire) + payload


def _bytes_field(number: int, data: bytes) -> bytes:
    return _field(number, 2, _varint(len(data)) + data)


def encode_event(wall_time: float, step: int, file_version: Optional[bytes] = None,
                 tag: Optional[str] = None, value: Optional[float] = None) -> bytes:
    """tensorflow.Event {wall_time = 1 (double), step = 2 (int64),
    file_version = 3 (string) | summary = 5 {value = 1 {tag = 1 (string),
    simple_value = 2 (float)}}} in protobuf wire format."""
    out = _field(1, 1, struct.pack("<d", wall_time)) + _field(2, 0, _varint(int(step)))
    if file_version is not None:
        return out + _bytes_field(3, file_version)
    val = _bytes_field(1, tag.encode()) + _field(2, 5, struct.pack("<f", value))
    return out + _bytes_field(5, _bytes_field(1, val))


def frame_record(data: bytes) -> bytes:
    """One TFRecord: length (uint64), its masked CRC, the data, its masked CRC."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


class EventFileWriter:
    """One events.out.tfevents.<time>.<host>... file of scalar events."""

    _count = 0

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        EventFileWriter._count += 1
        name = (f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}"
                f".{os.getpid()}.{EventFileWriter._count}")
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "wb")
        self._f.write(frame_record(encode_event(time.time(), 0, file_version=FILE_VERSION)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(frame_record(encode_event(time.time(), step, tag=tag, value=value)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def _fields(data: bytes):
    """(field number, wire type, value) of a protobuf message."""
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(data, pos)
        elif wire == 1:
            value, pos = data[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _read_varint(data, pos)
            value, pos = data[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = data[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"protobuf wire type {wire}")
        yield number, wire, value


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return result, pos


def read_scalars(path: str) -> List[Tuple[int, str, float]]:
    """The (step, tag, simple_value) scalars of an event file, in order;
    every record's CRCs are checked."""
    with open(path, "rb") as f:
        data = f.read()
    out, pos = [], 0
    while pos < len(data):
        length = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", length)
        if struct.unpack("<I", data[pos + 8:pos + 12])[0] != masked_crc32c(length):
            raise ValueError(f"{path}: bad length CRC at byte {pos}")
        record = data[pos + 12:pos + 12 + n]
        if struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])[0] != masked_crc32c(record):
            raise ValueError(f"{path}: bad data CRC at byte {pos}")
        pos += 16 + n
        step = 0
        for number, _, value in _fields(record):
            if number == 2:
                step = value
            elif number == 5:
                for _, _, val in _fields(value):
                    parts = {k: v for k, _, v in _fields(val)}
                    out.append((step, parts[1].decode(), struct.unpack("<f", parts[2])[0]))
    return out


class MetricLogger:
    """Scalars into TensorBoard event files under `log_dir` (or nothing,
    with use_tb False); wandb is not used: a request for it prints and
    falls back to the event files."""

    def __init__(self, log_dir: str, use_tb: bool = True, use_wandb: bool = False):
        self.writer = None
        if use_wandb:
            print("[logger] wandb unavailable (the port logs to TensorBoard event "
                  "files only); falling back to TB")
        if use_tb:
            self.writer = EventFileWriter(log_dir)

    def log(self, step: int, metrics: dict, prefix: str = "train"):
        if self.writer is not None:
            for k, v in metrics.items():
                self.writer.add_scalar(f"{prefix}/{k}", float(v), step)
            self.writer.flush()

    def close(self):
        if self.writer is not None:
            self.writer.close()


def save_comparison_image(path: str, rendered, target):
    """(rendered | target) side by side a frame, the frames stacked
    vertically, as one PNG: (T, H, W, 3) float in [0, 1] each."""
    rendered, target = np.asarray(rendered), np.asarray(target)
    rows = [np.concatenate([rendered[t], target[t]], axis=1)
            for t in range(rendered.shape[0])]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(to_uint8(np.concatenate(rows, axis=0))))


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def refuse_parallel(cfg) -> None:
    """training.devices or training.model_parallel above 1 raise: one card
    a process, nothing shards."""
    t = cfg.training
    n_data, n_model = int(t.get("devices", 1)), int(t.get("model_parallel", 1))
    if n_data > 1 or n_model > 1:
        raise NotImplementedError(
            f"training.devices={n_data}, training.model_parallel={n_model}: data and "
            f"tensor parallelism are not ported yet ({PARALLEL_ITEM}); set both to 1")


class Trainer:
    def __init__(self, cfg, train_step: Callable, eval_step: Optional[Callable],
                 output_dir: Optional[str] = None, render_fn: Optional[Callable] = None,
                 device=None):
        """render_fn(ref_batch) -> (rendered (B, T, H, W, 3), target (B, T,
        H, W, 3)) for the comparison PNGs. device: where batches go (CUDA
        unless "cpu" is asked for)."""
        refuse_parallel(cfg)
        t = cfg.training
        self.cfg = cfg
        self.device = resolve_device(device)
        self.train_step = train_step
        self.eval_step = eval_step
        self.render_fn = render_fn
        self.max_epochs = int(t.get("max_epochs", 1))
        self.fast_dev_run = bool(t.get("fast_dev_run", False))
        self.log_every = int(t.get("logging", {}).get("log_every_n_steps", 10))
        self.monitor = t.get("validation", {}).get("monitor", "val/loss_total")
        self.save_top_k = int(t.get("validation", {}).get("save_top_k", 1))
        self.val_every = int(t.get("validation", {}).get("val_every_n_epoch", 1))
        self.image_every = 500

        self.output_dir = output_dir or t.get("output_dir", "outputs")
        os.makedirs(self.output_dir, exist_ok=True)
        self.logger = MetricLogger(
            os.path.join(self.output_dir, "tb"), use_tb=not self.fast_dev_run,
            use_wandb=bool(t.get("logging", {}).get("use_wandb", False)))
        self.ckpt = None
        if not self.fast_dev_run:
            self.ckpt = CheckpointManager(os.path.join(self.output_dir, "checkpoints"),
                                          max_to_keep=self.save_top_k, monitor=self.monitor)
        self.best_metric = float("inf")

        # the logged learning rate: the schedule (without warmup, as the JAX
        # trainer's mirror of it) advanced once an accumulated update
        from ..configs.build import build_optim_config
        oc = build_optim_config(cfg)
        self._lr_accum = max(1, oc.accumulate_steps)
        self._lr = (oc.learning_rate, oc.learning_rate * oc.end_factor, oc.total_steps)

    def learning_rate(self, global_step: int) -> float:
        return float(_linear(*self._lr, global_step // self._lr_accum))

    def fit(self, state, train_data: Iterable, val_data: Optional[Iterable] = None,
            resume: bool = False):
        if resume and self.ckpt is not None:
            state, ok = self.ckpt.restore(state)
            if ok:
                print(f"[trainer] resumed at step {int(state.step)}")

        global_step = int(state.step)
        for epoch in range(self.max_epochs):
            for batch in train_data:
                ref, test, _bid = batch
                ref, test = to_device(ref, self.device), to_device(test, self.device)
                t0 = time.perf_counter()
                state, metrics = self.train_step(state, ref, test)
                if global_step % self.log_every == 0:
                    # reading the metrics back waits for the step's work
                    metrics = {k: float(v) for k, v in metrics.items()}
                    metrics["step_time_s"] = time.perf_counter() - t0
                    metrics["lr"] = self.learning_rate(global_step)
                    self.logger.log(global_step, metrics, "train")
                    print(f"[e{epoch} s{global_step}] " +
                          " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
                if self.render_fn is not None and global_step % self.image_every == 0:
                    rendered, target = self.render_fn(ref)
                    save_comparison_image(
                        os.path.join(self.output_dir, "train_images",
                                     f"comparison_{global_step}.png"),
                        _host(rendered[0]), _host(target[0]))
                global_step += 1
                if self.fast_dev_run:
                    break

            if val_data is not None and (epoch + 1) % self.val_every == 0:
                val_metrics = self.validate(state, val_data)
                self.logger.log(global_step, val_metrics, "val")
                self._maybe_checkpoint(state, global_step, val_metrics)
            elif self.ckpt is not None:
                self.ckpt.save(global_step, state)
            if self.fast_dev_run:
                break
        self.logger.close()
        return state

    def validate(self, state, val_data, save_images: bool = False) -> dict:
        if self.eval_step is None:
            return {}
        agg, n = {}, 0
        for batch in val_data:
            ref, test, _ = batch
            ref, test = to_device(ref, self.device), to_device(test, self.device)
            m = self.eval_step(ref, test)
            for k, v in m.items():
                agg[k] = agg.get(k, 0.0) + float(v)
            if save_images and self.render_fn is not None:
                rendered, target = self.render_fn(ref)
                save_comparison_image(
                    os.path.join(self.output_dir, "test_images",
                                 f"triplane_comparison_{n}.png"),
                    _host(rendered[0]), _host(target[0]))
            n += 1
            if self.fast_dev_run:
                break
        out = {k: v / max(n, 1) for k, v in agg.items()}
        out["loss_total"] = out.get("loss", 0.0)
        return out

    def _maybe_checkpoint(self, state, step: int, val_metrics: dict):
        if self.ckpt is None:
            return
        key = self.monitor.split("/")[-1]
        cur = val_metrics.get(key, val_metrics.get("loss_total", 0.0))
        self.ckpt.save(step, state, metrics={key: cur})
        if cur < self.best_metric:
            self.best_metric = cur
