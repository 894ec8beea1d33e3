"""Build and bind the port's hand-written Hopper kernels.

Each `csrc/*.cu` source has a plain C interface and is compiled by `nvcc`
for `sm_90a` into its own shared library under `<repo>/build/kernels/`,
named by a hash of the source, the shared `csrc/*.cuh` headers and the
flags, and loaded with `ctypes`. `build()`
compiles every missing library in parallel (one nvcc per source, all
started together); `library(name)` builds one on first use. Nothing is
compiled or loaded at import time, so the CPU tests can import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

_BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

# name -> (source, extra nvcc flags, {C function: (argtypes, restype)})
_P = ctypes.c_void_p
_I = ctypes.c_int
KERNELS = {
    "splat_segments": (
        "splat_segments.cu", ("--fmad=false",),
        {"splat_segments_launch": (
            [_P, ctypes.c_longlong, _P, _P, _I, _I, _I, _P, _P, _P], _I)}),
    "quad_rows": (
        "quad_rows.cu", (),
        {"quad_rows_launch": ([_P, _P, _P, _I, _I, _I, _I, _P], _I)}),
    "quad_rows_bwd": (
        "quad_rows_bwd.cu", (),
        {"quad_rows_bwd_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I)}),
    "attention": (
        "attention.cu", (),
        {"attention_launch": (
            [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P], _I),
         "attention_launch_nwg": (
            [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P, _I], _I),
         "attention_smem": ([_I], _I)}),
    "splat_tiles": (
        "splat_tiles.cu", ("--fmad=false",),
        {"splat_tiles_launch": ([_P, _I, _I, _I, _I, _P, _P], _I)}),
    "attention_bwd": (
        "attention_bwd.cu", (),
        {"attention_bwd_launch": (
            [_P] * 11 + [_I, _I, _I, _I, ctypes.c_float, _P], _I),
         "attention_bwd_smem": ([], _I)}),
    "splat_tiles_bwd": (
        "splat_tiles_bwd.cu", ("--fmad=false",),
        {"splat_tiles_bwd_launch": ([_P, _P, _I, _I, _I, _I, _P, _P], _I),
         "splat_tiles_bwd_smem": ([_I], _I)}),
    "winograd": (
        "winograd.cu", (),
        {"winograd_launch": ([_P] * 6 + [_I] * 6 + [_P], _I),
         "winograd_smem": ([_I], _I)}),
    "sfc_codes": (
        "sfc_codes.cu", (),
        {"sfc_codes_launch": ([_P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _I, _I, _P], _I)}),
    "subm_conv": (
        "subm_conv.cu", (),
        {"subm_conv_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I)}),
}

_loaded: Dict[str, ctypes.CDLL] = {}
# nvcc's output of each verbose build (ptxas's registers and spills)
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine with the card")
    return path


def _lib_path(name: str) -> str:
    src, flags, _ = KERNELS[name]
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for part in [src] + headers:
        with open(os.path.join(CSRC, part), "rb") as f:
            h.update(f.read())
    h.update(" ".join(_BASE_FLAGS + flags).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None,
          verbose: bool = False) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet, all
    nvcc processes started together. Returns {name: seconds} for the ones
    compiled; raises with nvcc's output when one fails."""
    names = list(KERNELS if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        src, flags, _ = KERNELS[name]
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *_BASE_FLAGS, *flags]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", tmp, os.path.join(CSRC, src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    seconds, errors = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{log}")
            continue
        if verbose and log:
            BUILD_LOGS[name] = log
            print(f"[kernels] {name}:\n{log}", flush=True)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def ptxas_usage(log: str) -> Dict[str, Dict[str, int]]:
    """{kernel entry (mangled): {registers, smem (static shared memory
    bytes), spill_stores, spill_loads, stack}} from the output of a build
    with `-Xptxas -v`."""
    usage: Dict[str, Dict[str, int]] = {}
    entry = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            usage[entry] = {}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            usage[entry].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[entry]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            usage[entry]["smem"] = int(m.group(1))
    return usage


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed, with the
    argtypes / restype of its C functions declared."""
    lib = _loaded.get(name)
    if lib is None:
        path = _lib_path(name)
        if not os.path.exists(path):
            build([name])
        lib = ctypes.CDLL(path)
        for fn, (argtypes, restype) in KERNELS[name][2].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def stream_ptr(device) -> int:
    """The current PyTorch stream on `device` as an int for ctypes."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
