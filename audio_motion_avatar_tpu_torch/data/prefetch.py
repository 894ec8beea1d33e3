"""Dataset prefetching over a native C++ ring (the JAX package's
data/prefetch.py).

`maybe_prefetch(dataset, num_workers)` wraps an indexable dataset in
`NativePrefetcher`: `num_workers` threads of the ring in csrc/prefetch.cpp
call `dataset[i]` ahead of the consumer, at most `capacity` items ahead,
so the host's decoding overlaps the device's steps; items come out in the
order they complete. The ring is built with g++ at first use into
build/host/ (a file named by the source's hash, written by rename, so
concurrent first uses do not race) and bound with ctypes. Where it cannot
be built or loaded, the prefetcher runs the JAX module's thread pool
instead, prints why, and says so in its `ring` attribute ("native" or
"threads") and its `error`. A read that raises raises in the consumer
when its item's turn comes (in the JAX module it ends a thread or hands
on a token that is not there).

The producer callbacks run on the ring's threads and take the GIL around
the Python work, so the overlap is as large as the dataset's time outside
the GIL (zlib, numpy's larger operations) and the consumer's. Items are
exchanged as integer tokens into a registry on the Python side: no Python
object crosses the C ABI.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import shutil
import subprocess
import threading
from typing import Iterator

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "prefetch.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "host")
FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-pthread")

_PRODUCER = ctypes.CFUNCTYPE(ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p)


def lib_path() -> str:
    """Where the ring's library is built: build/host/, named by the hash of
    its source and flags."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libamatprefetch_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/prefetch.cpp with g++ unless it is built; returns the
    library's path."""
    out = lib_path()
    if os.path.exists(out):
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise OSError("g++ not found on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([gxx, *FLAGS, SOURCE, "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        raise OSError(f"g++ failed ({proc.returncode}): {proc.stderr.strip()[:2000]}")
    os.replace(tmp, out)
    return out


def _load_lib():
    """The ring's library, built at first use; OSError when it cannot be
    built or loaded."""
    lib = ctypes.CDLL(build())
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_uint64, ctypes.c_uint64,
                                ctypes.c_uint64, _PRODUCER, ctypes.c_void_p]
    lib.ring_pop.restype = ctypes.c_uint64
    lib.ring_pop.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
    lib.ring_stop.argtypes = [ctypes.c_void_p]
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ring_size.restype = ctypes.c_uint64
    lib.ring_size.argtypes = [ctypes.c_void_p]
    return lib


class _Failed:
    """An item whose read raised: the consumer raises it again."""

    def __init__(self, error: BaseException):
        self.error = error


def _checked(item):
    if isinstance(item, _Failed):
        raise item.error
    return item


class NativePrefetcher:
    """Iterate `dataset` with `num_workers` C++ threads producing ahead,
    bounded by `capacity`. Yields items in completion order (training
    consumes them in any order), or in index order with `ordered` (the data
    ranks of a mesh, whose steps must read the same global batch); an item
    whose read raised raises when its turn comes. `ring` is "native", or
    "threads" when the library could not be built or loaded (`error` says
    why)."""

    def __init__(self, dataset, num_workers: int = 2, capacity: int = 4,
                 ordered: bool = False):
        self.dataset = dataset
        self.num_workers = num_workers
        self.capacity = capacity
        self.ordered = ordered
        try:
            self.lib, self.error = _load_lib(), None
        except OSError as e:
            self.lib, self.error = None, f"{type(e).__name__}: {e}"
            print(f"[prefetch] the native ring is unavailable ({self.error}); "
                  f"running {num_workers} Python threads")
        self.ring = "native" if self.lib is not None else "threads"

    def _read(self, index):
        try:
            return self.dataset[index]
        except Exception as e:      # raised again by the consumer
            return _Failed(e)

    def __len__(self):
        return len(self.dataset)

    def __iter__(self) -> Iterator:
        pairs = self._python_fallback() if self.lib is None else self._native()
        try:
            pending, want = {}, 0
            for index, item in pairs:
                if not self.ordered:
                    yield _checked(item)
                    continue
                pending[index] = item
                while want in pending:
                    yield _checked(pending.pop(want))
                    want += 1
        finally:
            pairs.close()

    def _native(self) -> Iterator:
        """(index, item) pairs from the ring, in completion order."""
        registry = {}
        reg_lock = threading.Lock()
        counter = [1]

        @_PRODUCER
        def produce(index, _ctx):
            item = self._read(int(index))
            with reg_lock:
                token = counter[0]
                counter[0] += 1
                registry[token] = item
            return token

        n = len(self.dataset)
        ring = self.lib.ring_create(n, self.capacity, self.num_workers, produce, None)
        try:
            for _ in range(n):
                idx = ctypes.c_uint64()
                token = self.lib.ring_pop(ring, ctypes.byref(idx))
                if token == ctypes.c_uint64(-1).value:
                    break
                with reg_lock:
                    item = registry.pop(token)
                yield int(idx.value), item
        finally:
            self.lib.ring_destroy(ring)

    def _python_fallback(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.capacity)
        n = len(self.dataset)
        SENTINEL = object()

        def worker(worker_id):
            for i in range(worker_id, n, self.num_workers):
                q.put((i, self._read(i)))
            q.put(SENTINEL)

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        done = 0
        while done < self.num_workers:
            item = q.get()
            if item is SENTINEL:
                done += 1
                continue
            yield item


def maybe_prefetch(dataset, num_workers: int = 0, capacity: int = 4,
                   ordered: bool = False):
    """num_workers = 0 -> the dataset itself (the reference default)."""
    if num_workers <= 0:
        return dataset
    return NativePrefetcher(dataset, num_workers, capacity, ordered)
