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
    """(R, V) -> (chunk maxima (R, V/128), row max (R,), sum(exp(x - max)) (R,)), f32."""
    R, V = x.shape
    x = x.float()
    cm = x.reshape(R, V // CHUNK, CHUNK).amax(dim=-1)
    mx = cm.amax(dim=-1)
    se = torch.exp(x - mx[:, None]).sum(dim=-1)
    return cm, mx, se


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=1)
def _launcher():
    """The kernel's C entry point, built and typed once per process."""
    fn = load("select_topk").row_stats_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def split_plan(R: int, C: int, sms: int) -> int:
    """Blocks per row: about four blocks per SM over all rows, each block
    at least 8 chunks deep, and no block left without a chunk."""
    parts = max(1, min(-(-4 * sms // max(R, 1)), C // 8))
    per = -(-C // parts)
    return -(-C // per)


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
    parts = split_plan(R, C, sm_count(dev))
    partial = torch.empty((2, R, parts), dtype=torch.float32, device=dev)  # max, sum
    with torch.cuda.device(dev):
        rc = _launcher()(x.data_ptr(), cm.data_ptr(), mx.data_ptr(), se.data_ptr(),
                         partial[0].data_ptr(), partial[1].data_ptr(), R, V, parts,
                         torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"select_topk kernel launch failed: CUDA error {rc}")
    row_stats_chunkmax.launches += 1
    return cm, mx, se


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
