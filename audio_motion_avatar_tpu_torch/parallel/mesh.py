"""The ('data', 'model') process mesh and the weights' shards (the JAX
package's parallel/mesh.py).

One process a card; `make_mesh(num_data, num_model)` lays the world out
row-major as a torch DeviceMesh with axes ('data', 'model'), rank =
d * num_model + m, and requires num_data * num_model == world, as the JAX
rule does over devices. Along 'data' each process reads its rows of every
global batch (`batch_rows`; items rank::num_data) and the gradients are
averaged before the clip; along 'model' the layers the JAX package
annotates with the logical axes 'heads', 'mlp' and 'conv_out' (mapped by
LOGICAL_RULES) hold a slice of their weights: `tp_rules` is the table of
those parameters and their shard dimension in the port's layout,
`shard_model` cuts a built model's parameters to this rank's slice and
hands the modules their ModelAxis (parallel/tensor.py computes with it).
`shard_state_dict` / `gather_state_dict` take a full state_dict
(weights.params_from_flax's output) to one rank's shards and back, bit for
bit; `gather_params` is the same gather across the processes.

The JAX package's flax axes, by site, and the port's dimension:
- transformer.Attention q / k / v ('embed', 'heads'): weight dim 0;
  out ('heads', 'embed'): weight dim 1, bias replicated;
- transformer.GEGLUFeedForward wi ('embed', 'mlp'), weight and bias dim 0
  in two halves (h, gate: each rank holds the same columns of both);
  wo ('mlp', 'embed'): weight dim 1;
- ptv3._PatchAttention (also the ViT's attention) query / key / value
  ('embed', 'heads', None) with their ('heads', None) biases: dim 0; out
  ('heads', None, 'embed'): weight dim 1;
- ptv3.SerialBlock and image_encoder.ViTBlock mlp1 ('embed', 'mlp') with
  its bias: dim 0; mlp2 ('mlp', 'embed'): weight dim 1;
- upsampler.ResBlock conv1 (None, None, 'embed', 'conv_out'): weight dim 0
  (its bias replicated); conv2 (None, None, 'conv_out', 'embed'): weight
  dim 1; the direct convs only: the Winograd ones ('winograd',
  'winograd_gn') replicate as _WinoConv does;
- upsampler.UpsampleBlock conv_kernel / conv_bias ('conv_out'): dim 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .distributed import world_size
from .tensor import ModelAxis

# flax logical axis -> mesh axis (the JAX package's rules)
LOGICAL_RULES = (
    ("batch", "data"),
    ("heads", "model"),
    ("mlp", "model"),
    ("conv_out", "model"),
    ("embed", None),
    ("embed_inner", None),
)

# (shard dimension, halves): halves 2 = the dimension is two halves split alike
Rule = Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the mesh; groups None on a 1 x 1 mesh."""
    num_data: int
    num_model: int
    data_rank: int = 0
    model_rank: int = 0
    device_mesh: Optional[object] = None

    @property
    def data_group(self):
        return None if self.device_mesh is None else self.device_mesh.get_group("data")

    @property
    def model_group(self):
        return None if self.device_mesh is None else self.device_mesh.get_group("model")

    @property
    def model_axis(self) -> Optional[ModelAxis]:
        if self.num_model == 1:
            return None
        return ModelAxis(self.model_group, self.num_model, self.model_rank)

    def __str__(self):
        return f"('data', 'model') = ({self.num_data}, {self.num_model})"


def make_mesh(num_data: Optional[int] = None, num_model: int = 1,
              device_type: Optional[str] = None) -> Mesh:
    """The mesh over every process (num_data None: world // num_model).
    device_type: the DeviceMesh's (default: cuda when the process has a
    current card, else cpu)."""
    world = world_size()
    if num_data is None:
        num_data = world // num_model
    if num_data * num_model != world:
        raise ValueError(f"mesh ({num_data}, {num_model}) needs {num_data * num_model} "
                         f"processes, the world has {world}")
    if world == 1:
        return Mesh(1, 1)
    from torch.distributed.device_mesh import DeviceMesh
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() and \
            dist.get_backend() == "nccl" else "cpu"
    dm = DeviceMesh(device_type, torch.arange(world).reshape(num_data, num_model),
                    mesh_dim_names=("data", "model"))
    return Mesh(num_data, num_model, dm.get_local_rank("data"),
                dm.get_local_rank("model"), dm)


def mesh_from_config(cfg) -> Mesh:
    """training.devices x training.model_parallel, shrunk to (world, 1) when
    more are asked for than there are processes (the JAX trainer's rule,
    with the world in place of its devices)."""
    t = cfg.get("training") or {}
    n_data, n_model = int(t.get("devices", 1)), int(t.get("model_parallel", 1))
    world = world_size()
    if n_data * n_model > world:
        n_data, n_model = world, 1
    if n_data * n_model != world:
        raise ValueError(f"training.devices={n_data} x training.model_parallel={n_model} "
                         f"!= {world} processes: start one process a mesh slot")
    return make_mesh(n_data, n_model)


# ---------------------------------------------------------------------------
# the 'model'-sharded parameters
# ---------------------------------------------------------------------------

def tp_rules(module: nn.Module) -> Dict[str, Rule]:
    """The module's own parameters (names relative to it) that shard over
    'model', with their rule; {} for a module that stays whole."""
    from ..models.image_encoder import ViTBlock
    from ..models.ptv3 import SerialBlock, _PatchAttention
    from ..models.transformer import Attention, GEGLUFeedForward
    from ..models.upsampler import ResBlock, UpsampleBlock

    col, row, halves = (0, 1), (1, 1), (0, 2)
    if isinstance(module, Attention):
        return {"q.weight": col, "k.weight": col, "v.weight": col, "out.weight": row}
    if isinstance(module, GEGLUFeedForward):
        return {"wi.weight": halves, "wi.bias": halves, "wo.weight": row}
    if isinstance(module, _PatchAttention):
        return {f"{n}.{p}": col for n in ("query", "key", "value")
                for p in ("weight", "bias")} | {"out.weight": row}
    if isinstance(module, (SerialBlock, ViTBlock)):
        return {"mlp1.weight": col, "mlp1.bias": col, "mlp2.weight": row}
    if isinstance(module, ResBlock) and module.conv_impl == "xla":
        return {"conv1.weight": col, "conv2.weight": row}
    if isinstance(module, UpsampleBlock):
        return {"conv_weight": col, "conv_bias": col}
    return {}


def _check_divides(name: str, module: nn.Module, n: int) -> None:
    from ..models.upsampler import ResBlock
    heads = getattr(module, "heads", None)
    if heads is not None and heads % n:
        raise ValueError(f"{name}: {heads} heads do not split over {n} model ranks")
    if isinstance(module, ResBlock) and module.norm_mode == "group" and \
            module.conv_impl == "xla" and module.groups % n:
        raise ValueError(f"{name}: GroupNorm's {module.groups} groups do not split "
                         f"over {n} model ranks")


def model_parallel_table(model: nn.Module) -> Dict[str, Rule]:
    """{state_dict key: rule} of every 'model'-sharded parameter."""
    table = {}
    for prefix, module in model.named_modules():
        for name, rule in tp_rules(module).items():
            table[f"{prefix}.{name}" if prefix else name] = rule
    return table


def _local_index(size: int, rule: Rule, n: int, r: int) -> List[Tuple[int, int]]:
    """(start, length) runs of rank r's slice of a dimension of `size`."""
    _, halves = rule
    if size % (halves * n):
        raise ValueError(f"a dimension of {size} does not split in {halves} x {n}")
    part, m = size // halves, size // (halves * n)
    return [(j * part + r * m, m) for j in range(halves)]


def shard_tensor(full: torch.Tensor, rule: Rule, n: int, r: int) -> torch.Tensor:
    dim = rule[0]
    runs = _local_index(full.shape[dim], rule, n, r)
    return torch.cat([full.narrow(dim, s, m) for s, m in runs], dim).contiguous()


def shard_state_dict(state_dict: Dict[str, torch.Tensor], table: Dict[str, Rule],
                     num_model: int, model_rank: int) -> Dict[str, torch.Tensor]:
    """A full state_dict -> model rank `model_rank`'s (other keys as they are)."""
    return {k: shard_tensor(v, table[k], num_model, model_rank) if k in table else v
            for k, v in state_dict.items()}


def gather_state_dict(shards: List[Dict[str, torch.Tensor]],
                      table: Dict[str, Rule]) -> Dict[str, torch.Tensor]:
    """Every model rank's state_dict, in rank order -> the full one."""
    out = {}
    for k, v in shards[0].items():
        if k not in table:
            out[k] = v
            continue
        dim = table[k][0]
        parts = [[] for _ in range(table[k][1])]
        for sd in shards:
            m = sd[k].shape[dim] // table[k][1]
            for j in range(table[k][1]):
                parts[j].append(sd[k].narrow(dim, j * m, m))
        out[k] = torch.cat([t for half in parts for t in half], dim)
    return out


def gather_params(local: Dict[str, torch.Tensor], table: Dict[str, Rule],
                  mesh: Mesh) -> Dict[str, torch.Tensor]:
    """gather_state_dict across the model group: each rank puts its slice
    into zeros and the group sums them (exact: one term of each sum is
    not 0). Every rank gets the full tensors; others pass through."""
    axis = mesh.model_axis
    if axis is None:
        return dict(local)
    out = {}
    for k, v in local.items():
        if k not in table or v is None:
            out[k] = v
            continue
        rule = table[k]
        shape = list(v.shape)
        shape[rule[0]] *= axis.size
        full = torch.zeros(shape, dtype=torch.float32, device=v.device)
        runs = _local_index(shape[rule[0]], rule, axis.size, axis.rank)
        m = runs[0][1]
        for j, (s, _) in enumerate(runs):
            full.narrow(rule[0], s, m).copy_(v.narrow(rule[0], j * m, m))
        dist.all_reduce(full, group=axis.group)
        out[k] = full.to(v.dtype)
    return out


@torch.no_grad()
def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Cut the model's 'model'-sharded parameters to this rank's slice (in
    place, before an optimizer is made over them) and give their modules
    the mesh's ModelAxis. A 1-wide 'model' axis leaves the model whole."""
    axis = mesh.model_axis
    if axis is None:
        return model
    for prefix, module in model.named_modules():
        rules = tp_rules(module)
        if not rules:
            continue
        _check_divides(prefix, module, axis.size)
        for name, rule in rules.items():
            p = module.get_parameter(name)
            p.data = shard_tensor(p.data, rule, axis.size, axis.rank)
        module.tp = axis
    return model


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------

def rows(x, mesh: Mesh):
    """Data rank `mesh.data_rank`'s rows (rank::num_data) of an array or
    tensor with the batch first; None stays None."""
    if x is None or mesh.num_data == 1:
        return x
    return x[mesh.data_rank::mesh.num_data]


def batch_rows(batch, mesh: Mesh):
    """A VideoBatch's rows of this data rank."""
    if mesh.num_data == 1:
        return batch
    return batch._replace(
        video=rows(batch.video, mesh),
        smpl_parms={k: rows(v, mesh) for k, v in batch.smpl_parms.items()},
        cam_parms={k: rows(v, mesh) for k, v in batch.cam_parms.items()},
        audio_features=rows(batch.audio_features, mesh),
        cropped_images=rows(batch.cropped_images, mesh),
        pcd_points=rows(batch.pcd_points, mesh))


@torch.no_grad()
def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every data rank's rows joined into the global batch (rank r's row k
    is row k n + r): each rank's rows placed into zeros, the data group
    sums them (exact, one term of each sum is not 0)."""
    n = mesh.num_data
    if n == 1:
        return x
    full = torch.zeros((x.shape[0] * n,) + tuple(x.shape[1:]), dtype=torch.float32,
                       device=x.device)
    full[mesh.data_rank::n] = x
    dist.all_reduce(full, group=mesh.data_group)
    return full.to(x.dtype)


@torch.no_grad()
def average_over_data(tensors: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The tensors' mean over the data ranks: one all-reduce of their
    float32 concatenation."""
    if mesh.num_data == 1 or not tensors:
        return tensors
    keys = list(tensors)
    flat = torch.cat([tensors[k].reshape(-1).float() for k in keys])
    dist.all_reduce(flat, group=mesh.data_group)
    flat /= mesh.num_data
    out, pos = {}, 0
    for k in keys:
        t = tensors[k]
        out[k] = flat[pos:pos + t.numel()].view(t.shape).to(t.dtype)
        pos += t.numel()
    return out


@torch.no_grad()
def reduce_metrics(metrics: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Scalar metrics of each data rank's rows -> those of the global batch:
    the mean over the ranks (each a mean over as many rows), *_min the
    minimum and *_max the maximum."""
    if mesh.num_data == 1 or not metrics:
        return metrics
    out = dict(metrics)
    devices = [v.device for v in metrics.values()
               if isinstance(v, torch.Tensor) and v.device.type != "cpu"]
    dev = devices[0] if devices else torch.device("cpu")
    for suffix, op in (("_min", dist.ReduceOp.MIN), ("_max", dist.ReduceOp.MAX),
                       (None, dist.ReduceOp.SUM)):
        keys = [k for k in metrics if (k.endswith(suffix) if suffix else
                                       not k.endswith(("_min", "_max")))]
        if not keys:
            continue
        t = torch.stack([torch.as_tensor(metrics[k]).to(dev, torch.float32).reshape(())
                         for k in keys])
        dist.all_reduce(t, op=op, group=mesh.data_group)
        if suffix is None:
            t = t / mesh.num_data
        out.update({k: t[i] for i, k in enumerate(keys)})
    return out
