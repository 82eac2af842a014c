"""One-pass row statistics for exact beam-candidate selection (port of
`omni_avsr_tpu/ops/select_topk.py`, kernel B5).

Per logits row the fused beam selection (`decode/decoding.py::beam_loop`
with `select_kernel=True`) needs the max of each 128-wide chunk (the
prefilter of `topk_chunked`), the row max and the softmax normaliser
sum(exp(x - max)). `row_stats_chunkmax` computes all three in one read of
the row. A CPU tensor takes the plain version beside it; a CUDA tensor
launches the hand-written kernel in `csrc/select_topk.cu` or raises.

Chunk maxima and the row max are bit-equal to the plain version (a max is
exact); the normaliser is summed in another order, so `lse` may differ in
the last ulp, as the JAX package documents for its kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..kernels import check, load, sm_count

CHUNK = 128
_RB = 8  # rows per grid step of the JAX kernel; only its predicate uses it here


def select_stats_supported(vocab_size: int) -> bool:
    """The JAX package's predicate, unchanged (`select_topk.py:42-49`), so
    that a vocabulary takes the same route in both packages: 128-aligned
    chunks and an (8, V) f32 block that fits the TPU's VMEM twice."""
    if vocab_size % CHUNK != 0:
        return False
    return _RB * vocab_size * 4 * 2 <= 13 * 2**20


def row_stats_chunkmax_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(R, V) -> (chunk maxima (R, V/128), row max (R,), sum(exp(x - max)) (R,)), f32.
    The exponentials and their sum are taken in f64 of the f32 x - max:
    the normaliser is then exact to f32 rounding, whatever the device's
    f32 exp (torch's CPU one is at times 1.5e-4 off when other threads run
    beside it)."""
    R, V = x.shape
    x = x.float()
    cm = x.reshape(R, V // CHUNK, CHUNK).amax(dim=-1)
    mx = cm.amax(dim=-1)
    se = torch.exp((x - mx[:, None]).double()).sum(dim=-1).float()
    return cm, mx, se


def row_stats_chunkmax_split(x: torch.Tensor, parts: int, per: int):
    """The kernel's partition in torch, for the tests: each row's chunks cut
    into `parts` runs of `per` (the last may be shorter), each run's (max,
    sum of exp(x - max)), merged in the order of the runs as the row's last
    block merges them, in f64 as the plain version sums. Equal to the
    plain version up to the order of the sums."""
    R, V = x.shape
    xc = x.float().reshape(R, V // CHUNK, CHUNK)
    m = torch.full((R,), -torch.inf, dtype=torch.float32, device=x.device)
    s = torch.zeros((R,), dtype=torch.float64, device=x.device)
    for p in range(parts):
        run = xc[:, p * per:(p + 1) * per]
        pm = run.amax(dim=(1, 2))
        ps = torch.exp((run - pm[:, None, None]).double()).sum(dim=(1, 2))
        new = torch.maximum(m, pm)
        s = s * torch.exp((m - new).double()) + ps * torch.exp((pm - new).double())
        m = new
    return xc.amax(dim=-1), m, s.float()


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
BLOCKS_PER_SM = 4  # the kernel's occupancy: 256 threads of at most 64 registers a block
MIN_CHUNKS = 8  # a block's least chunks: one for each of its warps


@functools.lru_cache(maxsize=1)
def _launcher():
    """The kernel's C entry point, built and typed once per process."""
    fn = load("select_topk").row_stats_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def row_plan(R: int, C: int, sms: int) -> Tuple[int, int]:
    """(parts, per): each of the R rows split into `parts` blocks of `per`
    chunks (the last may hold fewer, none holds 0), so that the R * parts
    blocks fit the card at once, BLOCKS_PER_SM on each SM, with at least
    MIN_CHUNKS chunks a block; one block per row once R reaches half the
    card's slots. R * parts never exceeds the slots when parts > 1."""
    slots = BLOCKS_PER_SM * sms
    parts = max(1, min(slots // max(R, 1), -(-C // MIN_CHUNKS)))
    per = -(-C // parts)
    return -(-C // per), per


@functools.lru_cache(maxsize=None)
def _scratch(device: torch.device, stream: int) -> torch.Tensor:
    """The kernel's row tickets and per-block (max, sum) pairs, made once
    per device and stream (launches on one stream run in order; the kernel
    leaves every ticket at 0): `slots` pairs of f32, then `slots` int32
    tickets, `slots` being the most blocks `row_plan` splits rows into."""
    slots = BLOCKS_PER_SM * sm_count(device)
    return torch.zeros(3 * slots, dtype=torch.int32, device=device)


def _launch(x: torch.Tensor):
    R, V = x.shape
    C = V // CHUNK
    check("x", x, (R, V), torch.float32)
    dev = x.device
    cm = torch.empty((R, C), dtype=torch.float32, device=dev)
    mx = torch.empty((R,), dtype=torch.float32, device=dev)
    se = torch.empty((R,), dtype=torch.float32, device=dev)
    if R == 0:
        return cm, mx, se
    parts, per = _plan(R, C, sm_count(dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = _scratch(dev, stream)
        slots = scratch.numel() // 3
        rc = _launcher()(x.data_ptr(), cm.data_ptr(), mx.data_ptr(), se.data_ptr(),
                         scratch.data_ptr(), scratch.data_ptr() + 8 * slots, slots, R, V, parts,
                         per, stream)
    if rc != 0:
        raise RuntimeError(f"select_topk kernel launch failed: CUDA error {rc}")
    row_stats_chunkmax.launches += 1
    return cm, mx, se


_plan = functools.lru_cache(maxsize=1024)(row_plan)  # the wrapper's: once per shape


def row_stats_chunkmax(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(R, V) f32 logits, V % 128 == 0 -> (chunk maxima (R, V/128), row
    max (R,), sum(exp(x - row max)) (R,)); lse = log(sum). CPU tensors
    take the plain version; CUDA tensors (f32, contiguous) launch B5 and
    count the launch in `row_stats_chunkmax.launches`."""
    if x.dim() != 2 or x.shape[-1] % CHUNK:
        raise ValueError(f"row_stats_chunkmax: shape {tuple(x.shape)}, needs (R, V) with "
                         f"V % {CHUNK} == 0")
    if x.device.type == "cpu":
        return row_stats_chunkmax_plain(x)
    return _launch(x)


row_stats_chunkmax.launches = 0
