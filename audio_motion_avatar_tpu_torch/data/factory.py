"""Dataset factory (the JAX package's data/factory.py): the train split
uses training.batch_size, the evaluation splits batch 1.

`SyntheticDataset` batches itself; `ThumanDataset`, `AvatarDataset`
(IDOL) and `GaussianAudioDataset` yield B = 1 items, which the loader
groups by training.batch_size (containers.CollatedBatches, the trailing
partial group dropped). training.dataloader.num_workers > 0 reads the
train split's items through the prefetch ring (data/prefetch.py), ahead
of the steps and in the order they complete; the JAX package wraps the
grouped batches instead, which its ring cannot index, so there the ring
runs at batch size 1 only.

Over a mesh with data ranks (parallel/mesh.py) training.batch_size stays
the global batch, as under the JAX mesh, and each data rank reads only its
rows of it: items g B + rank + k n of global batch g (DataRankItems, read
through the ring in order so that every rank's step g is global batch g),
or the rows rank::n of a batch that batches itself. The batch id is the
global batch's (its first item's index, which is the id every reader
returns), so the ranks key the stage-2 cache alike. The evaluation splits
are read whole on every rank.
"""

from __future__ import annotations

from .containers import CollatedBatches
from .prefetch import maybe_prefetch
from .synthetic import SyntheticDataset


class DataRankItems:
    """The B = 1 items data rank `rank` of `n` reads: item j is item
    g B + rank + k n of the dataset (g, k = divmod(j, B / n)), tagged with
    the global batch's id g B."""

    def __init__(self, dataset, batch_size: int, rank: int, n: int):
        if batch_size % n:
            raise ValueError(f"training.batch_size={batch_size} does not split over "
                             f"{n} data ranks")
        self.dataset, self.batch_size, self.rank, self.n = dataset, batch_size, rank, n
        self.local = batch_size // n

    def __len__(self):
        return len(self.dataset) // self.batch_size * self.local

    def __getitem__(self, j):
        if not 0 <= j < len(self):
            raise IndexError(j)
        g, k = divmod(j, self.local)
        ref, tgt, _ = self.dataset[g * self.batch_size + self.rank + k * self.n]
        return ref, tgt, g * self.batch_size

    def __iter__(self):
        for j in range(len(self)):
            yield self[j]


class DataRankRows:
    """A dataset that batches itself, each batch cut to data rank's rows."""

    def __init__(self, dataset, mesh):
        if int(dataset.kw["batch_size"]) % mesh.num_data:
            raise ValueError(f"training.batch_size={dataset.kw['batch_size']} does not "
                             f"split over {mesh.num_data} data ranks")
        self.dataset, self.mesh = dataset, mesh

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        from ..parallel.mesh import batch_rows
        ref, tgt, bid = self.dataset[i]
        return batch_rows(ref, self.mesh), batch_rows(tgt, self.mesh), bid

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class DatasetFactory:
    @staticmethod
    def create_dataset(cfg, split: str = "train", device="cpu"):
        """device: where a SyntheticDataset with render_gt renders its
        targets and where GaussianAudioDataset computes its audio features
        (the items are numpy either way)."""
        dtype = cfg.dataset.get("type", "SyntheticDataset")
        if dtype == "SyntheticDataset":
            ds_cfg = cfg.dataset
            return SyntheticDataset(
                length=int(ds_cfg.get("length", 8)),
                batch_size=int(cfg.training.batch_size) if split == "train" else 1,
                ref_frames=int(ds_cfg.get("ref_frames", 2)),
                target_frames=int(ds_cfg.get("target_frames", 6)),
                image_size=tuple(ds_cfg.image_size),
                # the synthetic stand-in serves both stages: audio features
                # on every batch, which stage 1 ignores
                with_audio=True,
                audio_dim=int(ds_cfg.get("audio_feature_dim", 768)),
                seed=0 if split == "train" else 10_000,
                render_gt=bool(ds_cfg.get("render_gt", False)),
                device=device,
            )
        if dtype == "ThumanDataset":
            from .thuman import ThumanDataset
            return ThumanDataset(cfg, split)
        if dtype == "IDOLDataset":
            from .idol import AvatarDataset
            return AvatarDataset(cfg, split)
        if dtype == "GaussianAudioDataset":
            from .speech import GaussianAudioDataset
            return GaussianAudioDataset(cfg, split, device=device)
        raise ValueError(f"Unknown dataset type: {dtype}")

    @staticmethod
    def create_dataloader(cfg, split: str = "train", device="cpu", mesh=None):
        """The dataset as an iterable of (ref, target, id) batches: a reader
        of B = 1 items grouped by training.batch_size on the train split,
        read through the prefetch ring when training.dataloader.num_workers
        > 0 (train split only). mesh: over data ranks, the train split's
        batches are this rank's rows (module docstring)."""
        ds = DatasetFactory.create_dataset(cfg, split, device)
        bs = int(cfg.training.batch_size) if split == "train" else 1
        workers = int(cfg.training.get("dataloader", {}).get("num_workers", 0)) \
            if split == "train" else 0
        batched = isinstance(ds, SyntheticDataset)      # it batches itself
        n = 1 if mesh is None or split != "train" else mesh.num_data
        if n > 1 and batched:
            return maybe_prefetch(DataRankRows(ds, mesh), workers, ordered=True)
        if n > 1:
            ds = maybe_prefetch(DataRankItems(ds, bs, mesh.data_rank, n), workers,
                                ordered=True)
            return CollatedBatches(ds, bs // n) if bs > n else ds
        ds = maybe_prefetch(ds, workers)
        if bs > 1 and not batched:
            ds = CollatedBatches(ds, bs)
        return ds
