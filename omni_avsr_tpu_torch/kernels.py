"""Build and load the port's CUDA kernels: plain `nvcc` into a shared
library with a C interface, loaded with ctypes.

Each `csrc/<name>.cu` is compiled for sm_90a on first use into
`build/torch_kernels/` at the repository root, under a file name that
carries a hash of the source and of the shared `csrc/*.cuh` headers, so
an edited source is rebuilt and an unchanged one is loaded as it is.
`build_all` starts one `nvcc` per source at once; each build keeps ptxas's
report (registers, shared memory, spills per kernel) beside its library
(`ptxas_report`). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Iterable, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


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
        out.with_suffix(".ptxas.txt").write_text(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [library_path(n) for n in names]


def _kernel_name(mangled: str) -> str:
    """`name<int and bool template arguments>` of a mangled kernel symbol:
    the length-prefixed identifier that ends in "_kernel", and the integers
    and bools (Li<n>E, Lb<n>E) after it."""
    found = []  # (length, end): the shortest one is the kernel's own name
    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group(0))):
            n = int(m.group(0)[i:])
            if mangled[m.end(): m.end() + n].endswith("_kernel"):
                found.append((n, m.end()))
    if not found:
        return mangled
    n, start = min(found)
    args = ",".join(re.findall(r"L[ib](\d+)E", mangled[start + n:].split("EEv")[0]))
    return mangled[start: start + n] + (f"<{args}>" if args else "")


def ptxas_report(name: str) -> List[dict]:
    """ptxas's report for each kernel of the built csrc/<name>.cu: the
    kernel (its template arguments), registers, static shared memory and
    spill bytes, and whether ptxas serialised its wgmma instructions.
    Dynamic shared memory is set per launch by the wrappers."""
    path = library_path(name).with_suffix(".ptxas.txt")
    rows: List[dict] = []
    lines = path.read_text().splitlines() if path.exists() else []
    serialised = {m.group(1) for line in lines if "serialized" in line
                  for m in [re.search(r"function '(\w+)'", line)] if m}
    for line in lines:
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            rows.append({"kernel": _kernel_name(entry.group(1)),
                         "wgmma_serialized": entry.group(1) in serialised})
        elif rows and "spill" in line:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line).groups()
            rows[-1].update(spill_stores=int(st), spill_loads=int(ld))
        elif rows and "Used" in line:
            rows[-1]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            rows[-1]["static_smem"] = int(smem.group(1)) if smem else 0
    return rows


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
