"""Build and load the port's CUDA kernels: plain `nvcc` into a shared
library with a C interface, loaded with ctypes.

Each `csrc/<name>.cu` is compiled for sm_90a on first use into
`build/torch_kernels/` at the repository root, under a file name that
carries a hash of the source and of the shared `csrc/*.cuh` headers, so
an edited source is rebuilt and an unchanged one is loaded as it is.
`build_all` starts one `nvcc` per source at once. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterable, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(path)


def library_path(name: str) -> Path:
    """The library's path, keyed by the source and the shared headers."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, temp path, final path),
    or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names: Iterable[str]) -> List[Path]:
    """Build every named kernel library, all nvcc processes at once."""
    names = list(names)
    jobs = [(n, _start_build(n)) for n in names]
    errors = []
    for name, job in jobs:
        if job is None:
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [library_path(n) for n in names]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed (once
    per process: a loaded shared library stays loaded)."""
    build_all([name])
    return ctypes.CDLL(str(library_path(name)))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The device's streaming multiprocessors, for the wrappers' grid plans."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(name: str, t: torch.Tensor, shape, dtype) -> None:
    """What every kernel wrapper asks of a tensor it hands to a kernel:
    the shape and dtype the kernel reads, on a CUDA device, contiguous and
    16-byte aligned (the kernels load 16 bytes at a time)."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_cuda:
        raise ValueError(f"{name}: not on a CUDA device")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: not 16-byte aligned")
