"""Multi-process runtime initialization (the JAX package's
parallel/distributed.py).

One process per card. `maybe_initialize(cfg)` starts the
torch.distributed process group when the run is multi-process, which it
reads from, in this order:

- torchrun's environment (WORLD_SIZE > 1 with RANK, LOCAL_RANK,
  MASTER_ADDR, MASTER_PORT): `env://`;
- the JAX package's variables: JAX_COORDINATOR_ADDRESS (host:port, read as
  tcp://), JAX_NUM_PROCESSES the world size, JAX_PROCESS_ID the rank;
- AMA_MULTIHOST=1 or training.multihost: true, which then needs one of the
  two above (torch has no coordinator discovery of its own).

Without any of them it does nothing (a single process). The process binds
cuda:LOCAL_RANK (LOCAL_RANK, else the rank modulo the cards on the host;
or the device the caller names) and joins over NCCL on the card, gloo on
the CPU. Gloo with CUDA tensors (two ranks sharing one card, which NCCL
refuses) is used only when the caller passes backend="gloo". Nothing falls
back: a NCCL failure raises. Repeated calls return the first outcome.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Rendezvous:
    init_method: str
    world_size: int
    rank: int
    local_rank: Optional[int]      # None: the rank modulo the host's cards


def _wants_multihost(cfg, environ: Mapping[str, str]) -> bool:
    want = environ.get("AMA_MULTIHOST", "") not in ("", "0", "false")
    if cfg is not None:
        training = cfg.get("training") if hasattr(cfg, "get") else getattr(cfg, "training", None)
        if training is not None:
            want = want or bool(training.get("multihost", False))
    return want


def rendezvous(cfg=None, environ: Optional[Mapping[str, str]] = None
               ) -> Optional[Rendezvous]:
    """Where and as what this process joins, or None for a single process."""
    env = os.environ if environ is None else environ
    local = env.get("LOCAL_RANK")
    local = None if local is None else int(local)
    if int(env.get("WORLD_SIZE", "1")) > 1:
        missing = [k for k in ("RANK", "MASTER_ADDR", "MASTER_PORT") if k not in env]
        if missing:
            raise ValueError(f"WORLD_SIZE={env['WORLD_SIZE']} without {missing}: start the "
                             "processes with torchrun")
        return Rendezvous("env://", int(env["WORLD_SIZE"]), int(env["RANK"]), local)
    coord = env.get("JAX_COORDINATOR_ADDRESS")
    if coord:
        addr = coord if "://" in coord else f"tcp://{coord}"
        return Rendezvous(addr, int(env.get("JAX_NUM_PROCESSES", "1")),
                          int(env.get("JAX_PROCESS_ID", "0")), local)
    if not _wants_multihost(cfg, env):
        return None
    if all(k in env for k in ("RANK", "MASTER_ADDR", "MASTER_PORT")):
        return Rendezvous("env://", int(env.get("WORLD_SIZE", "1")), int(env["RANK"]), local)
    raise ValueError(
        "training.multihost / AMA_MULTIHOST asks for a multi-process run, but neither "
        "torchrun's variables (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) nor "
        "JAX_COORDINATOR_ADDRESS (with JAX_NUM_PROCESSES, JAX_PROCESS_ID) are set")


def bound_device(rdv: Rendezvous, device=None) -> torch.device:
    """The device this process runs on: `device` when it names an index or
    the CPU, else cuda:LOCAL_RANK."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA requested but torch.cuda.is_available() is False; "
                           "pass device='cpu' for a gloo run on the CPU")
    local = rdv.local_rank
    if local is None:
        local = rdv.rank % torch.cuda.device_count()
    return torch.device("cuda", local)


def maybe_initialize(cfg=None, backend: Optional[str] = None, device=None) -> bool:
    """Join the process group if this is a multi-process run (see the
    module docstring); returns whether a group exists. backend: None picks
    NCCL for a CUDA device and gloo for the CPU; "gloo" on a CUDA device is
    the caller's explicit choice."""
    if dist.is_initialized():
        return True
    rdv = rendezvous(cfg)
    if rdv is None:
        return False
    dev = bound_device(rdv, device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend nccl needs a CUDA device; the CPU runs gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=rdv.init_method,
                            world_size=rdv.world_size, rank=rdv.rank)
    # every rank joined, and the backend moved a tensor (NCCL raises here)
    dist.barrier(device_ids=[dev.index]) if backend == "nccl" else dist.barrier()
    if dist.get_rank() == 0:
        print(f"[distributed] initialized: process {rdv.rank}/{rdv.world_size}, "
              f"backend {backend}, device {dev}")
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """The process that writes the run's files (rank 0)."""
    return rank() == 0
