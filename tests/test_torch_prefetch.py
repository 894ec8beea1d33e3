"""The prefetch ring (data/prefetch.py): the four behaviours of the JAX
package's tests/test_prefetch.py on the port's NativePrefetcher (all items,
overlap, the thread fallback, zero workers), the port building and loading
its own copy of the ring (csrc/prefetch.cpp into build/host/, not the JAX
package's native/libamatprefetch.so), a missing g++ made visible, and a
failed read raised in the consumer on either ring (the factory's use of the
ring is in test_torch_data_io.py)."""

import os
import time

import pytest

from audio_motion_avatar_tpu_torch.data import prefetch
from audio_motion_avatar_tpu_torch.data.prefetch import NativePrefetcher, maybe_prefetch
from torch_parity import one_torch_thread  # noqa: F401


class SlowDataset:
    def __init__(self, n=16, delay=0.01):
        self.n = n
        self.delay = delay

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(self.delay)
        return i * 10


def test_port_builds_and_loads_its_own_ring():
    pf = NativePrefetcher(SlowDataset(2), num_workers=2)
    assert pf.ring == "native" and pf.lib is not None, pf.error
    path = prefetch.lib_path()
    assert os.path.exists(path) and os.path.dirname(path) == prefetch.BUILD_DIR
    assert os.path.basename(prefetch.BUILD_DIR) == "host"
    assert os.path.basename(os.path.dirname(prefetch.BUILD_DIR)) == "build"
    assert prefetch.build() == path          # built once, then found
    assert sorted(pf) == [0, 10]


def test_prefetch_yields_all_items():
    pf = NativePrefetcher(SlowDataset(16), num_workers=4, capacity=4)
    assert pf.ring == "native"
    assert sorted(pf) == [i * 10 for i in range(16)]


def test_prefetch_overlaps_work():
    """4 workers on a 10 ms-an-item dataset beat the serial reads by ~2x+."""
    ds = SlowDataset(24, delay=0.01)
    t0 = time.time()
    _ = [ds[i] for i in range(len(ds))]
    serial = time.time() - t0
    pf = NativePrefetcher(ds, num_workers=4, capacity=8)
    t0 = time.time()
    items = list(pf)
    parallel = time.time() - t0
    assert len(items) == 24
    assert parallel < serial * 0.7, (serial, parallel)


def test_python_fallback():
    pf = NativePrefetcher(SlowDataset(8), num_workers=2, capacity=2)
    pf.lib = None  # force the fallback
    assert sorted(pf) == [i * 10 for i in range(8)]


def test_maybe_prefetch_zero_workers():
    ds = SlowDataset(4)
    assert maybe_prefetch(ds, 0) is ds


def test_an_unbuildable_ring_is_visible(monkeypatch, capsys):
    """Without g++ the prefetcher says so and runs the thread pool."""
    monkeypatch.setattr(prefetch, "lib_path", lambda: "/nonexistent/libamatprefetch.so")
    monkeypatch.setattr(prefetch.shutil, "which", lambda name: None)
    pf = NativePrefetcher(SlowDataset(3), num_workers=2)
    assert pf.ring == "threads" and "g++ not found" in pf.error
    assert "native ring is unavailable" in capsys.readouterr().out
    assert sorted(pf) == [0, 10, 20]


class FailingDataset(SlowDataset):
    def __getitem__(self, i):
        if i == 3:
            raise FileNotFoundError(f"item {i}")
        return super().__getitem__(i)


@pytest.mark.parametrize("ring", ["native", "threads"])
def test_a_failed_read_raises_in_the_consumer(ring):
    """A read that raises reaches the loop that consumes the items, on
    either ring."""
    pf = NativePrefetcher(FailingDataset(8, delay=0.001), num_workers=3, capacity=2)
    if ring == "threads":
        pf.lib = None
    t0 = time.time()
    with pytest.raises(FileNotFoundError, match="item 3"):
        list(pf)
    assert time.time() - t0 < 10
