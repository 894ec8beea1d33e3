"""Dataset factory (the JAX package's data/factory.py): the train split
uses training.batch_size, the evaluation splits batch 1.

`SyntheticDataset` batches itself; `ThumanDataset` and
`GaussianAudioDataset` yield B = 1 items, which the loader groups by
training.batch_size (containers.CollatedBatches, the trailing partial
group dropped). `IDOLDataset` and the prefetch ring of `num_workers > 0`
raise, naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from .containers import CollatedBatches
from .synthetic import SyntheticDataset

# ROADMAP.md section 1 item 6: the data layer beyond these readers
_DATA_ITEM = "ROADMAP.md section 1 item 6 (data)"
_NOT_PORTED = ("IDOLDataset",)


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
        if dtype == "GaussianAudioDataset":
            from .speech import GaussianAudioDataset
            return GaussianAudioDataset(cfg, split, device=device)
        if dtype in _NOT_PORTED:
            raise NotImplementedError(
                f"dataset type {dtype!r} is not ported yet ({_DATA_ITEM}); "
                "use ThumanDataset, GaussianAudioDataset or SyntheticDataset")
        raise ValueError(f"Unknown dataset type: {dtype}")

    @staticmethod
    def create_dataloader(cfg, split: str = "train", device="cpu"):
        """The dataset as an iterable of (ref, target, id) batches: a reader
        of B = 1 items grouped by training.batch_size on the train split.
        training.dataloader.num_workers > 0 (the JAX package's prefetch
        ring) raises."""
        ds = DatasetFactory.create_dataset(cfg, split, device)
        bs = int(cfg.training.batch_size) if split == "train" else 1
        if bs > 1 and not isinstance(ds, SyntheticDataset):
            ds = CollatedBatches(ds, bs)
        workers = int(cfg.training.get("dataloader", {}).get("num_workers", 0)) \
            if split == "train" else 0
        if workers > 0:
            raise NotImplementedError(
                f"training.dataloader.num_workers={workers}: the prefetch ring is "
                f"not ported yet ({_DATA_ITEM}); set it to 0")
        return ds
