"""Host-object exchange between processes (the JAX package's
parallel/collectives.py): the stage-2 prediction cache's all-gather, the
reference's dist.all_gather_object. A single process gets [obj]."""

from __future__ import annotations

from typing import Any, List

import torch.distributed as dist


def process_count(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def all_gather_host_objects(obj: Any, group=None) -> List[Any]:
    """One picklable object a process -> every process's, in rank order
    (within `group`, default the world)."""
    n = process_count(group)
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj, group=group)
    return out


def cache_sync(new_item: dict, group=None) -> List[dict]:
    """The stage-2 cache exchange: each data rank adds at most one cache
    entry a step (its rows of the global batch); everyone merges
    everyone's."""
    return all_gather_host_objects(new_item or {}, group)
