"""Flash attention forward: the port of the TPU kernel
`omni_avsr_tpu/ops/flash_attention.py::_kernel` (B3).

softmax(q k^T * scale) v in the JAX layout, q (B, T, Hq, D) and k, v
(B, S, Hkv, D): bidirectional or causal, per-batch key lengths, GQA,
optional row logsumexp (B * Hq, T) f32, optional attention-probability
dropout with the TPU kernel's position-hash keep mask (`keep_mask`), so the
forward and a later backward draw the same mask whatever their tiling.

`flash_attention` is the wrapper the encoders call. A tensor on the CPU
takes `flash_attention_plain`, the same function in torch; a CUDA tensor
launches the hand-written kernel in `csrc/flash_attention.cu` (wgmma and
TMA, built with nvcc on first use) or raises. The kernel gives 0 for a
batch entry whose key length is 0, where the plain version averages v.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Union

import torch

from ..kernels import check, load

NEG_INF = -1e30  # the TPU kernel's mask value
_M32 = 0xFFFFFFFF

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 4 \
    + [ctypes.c_float, ctypes.c_void_p]


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for x in [0, 2^32) held in int64, without overflow:
    the constant is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _threshold(rate: float) -> int:
    t = int(round(rate * 2**32 - 2**31))
    return max(-(2**31), min(2**31 - 1, t))


def keep_mask(seed, h, q_start, k_start, block_q: int, block_k: int, seq_k: int,
              rate: float) -> torch.Tensor:
    """Torch copy of `_keep_mask` (`omni_avsr_tpu/ops/flash_attention.py:30-55`):
    (block_q, block_k) bool, True = keep. `h` (the flattened batch * Hq +
    head index) may be an int or a tensor, whose shape then leads the
    result. Computed in uint32 arithmetic held in int64."""
    dev = h.device if isinstance(h, torch.Tensor) else None
    h = torch.as_tensor(h, dtype=torch.int64, device=dev)
    qi = int(q_start) + torch.arange(block_q, dtype=torch.int64, device=dev)[:, None]
    ki = int(k_start) + torch.arange(block_k, dtype=torch.int64, device=dev)[None, :]
    x = (qi * int(seq_k) + ki) & _M32
    x = (x + _mul32(h[..., None, None] & _M32, 0x9E3779B9)) & _M32
    x = x ^ (int(seed) & _M32)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    signed = torch.where(x >= 2**31, x - 2**32, x)
    return signed >= _threshold(rate)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
    kv_lengths: Optional[torch.Tensor] = None,
    return_lse: bool = False,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[Union[int, torch.Tensor]] = None,
):
    """The kernel's function in torch: f32 logits, masked entries -1e30,
    softmax denominator before dropout, kept probabilities scaled by
    1/(1 - rate) and cast to v's dtype for the f32-accumulated value
    product, out = acc / max(l, 1e-30) in q's dtype."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    dev = q.device
    qg = q.reshape(B, T, Hkv, G, D).float()
    s = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) * scale  # (B, Hkv, G, T, S)
    kj = torch.arange(S, device=dev)
    valid = torch.ones((B, T, S), dtype=torch.bool, device=dev)
    if kv_lengths is not None:
        valid = valid & (kj[None, None, :] < kv_lengths.to(dev)[:, None, None])
    if causal:
        valid = valid & (kj[None, None, :] <= torch.arange(T, device=dev)[None, :, None])
    s = torch.where(valid[:, None, None], s, torch.full((), NEG_INF, device=dev))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 needs a dropout_seed")
        heads = torch.arange(B * Hq, device=dev)
        keep = keep_mask(int(dropout_seed), heads, 0, 0, T, S, S, dropout_rate)
        keep = keep.reshape(B, Hkv, G, T, S)
        p = torch.where(keep, p, torch.zeros((), device=dev)) * (1.0 / (1.0 - dropout_rate))
    acc = torch.einsum("bhgts,bshd->bhgtd", p.to(v.dtype).float(), v.float())
    out = (acc / l).permute(0, 3, 1, 2, 4).reshape(B, T, Hq, D).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l))[..., 0].reshape(B * Hq, T)
    return out


@functools.lru_cache(maxsize=1)
def _launcher():
    """The kernel's C entry point, built and typed once per process."""
    fn = load("flash_attention").flash_attention_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, scale, causal, kv_lengths, return_lse, dropout_rate, dropout_seed):
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if D not in (64, 128):
        raise ValueError(f"head_dim {D}: the kernel takes 64 or 128")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq {Hq} not a multiple of Hkv {Hkv}")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate {dropout_rate} outside [0, 1)")
    scale = D ** -0.5 if scale is None else float(scale)
    if not math.isfinite(scale):
        raise ValueError(f"scale {scale}: the kernel takes a finite scale")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 needs a dropout_seed")
    bf16 = torch.bfloat16
    check("q", q, (B, T, Hq, D), bf16)
    check("k", k, (B, S, Hkv, D), bf16)
    check("v", v, (B, S, Hkv, D), bf16)
    lens_ptr = None
    if kv_lengths is not None:
        check("kv_lengths", kv_lengths, (B,), torch.int32)
        lens_ptr = kv_lengths.data_ptr()
    if len({t.device for t in (q, k, v, kv_lengths) if t is not None}) != 1:
        raise ValueError("inputs on several devices")
    if B * T * S == 0:
        raise ValueError(f"empty attention: B {B}, T {T}, S {S}")
    out = torch.empty_like(q)
    lse = torch.empty((B * Hq, T), dtype=torch.float32, device=q.device) if return_lse else None
    seed = int(dropout_seed) if dropout_rate > 0.0 else 0
    seed = ((seed & _M32) ^ 2**31) - 2**31  # as a signed 32-bit int, for ctypes
    with torch.cuda.device(q.device):
        rc = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None, lens_ptr,
            B, T, S, Hq, Hkv, D, scale, int(causal),
            int(dropout_rate > 0.0), seed, _threshold(dropout_rate) if dropout_rate > 0.0 else 0,
            float(1.0 / (1.0 - dropout_rate)),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


def flash_attention(
    q: torch.Tensor,  # (B, T, Hq, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
    kv_lengths: Optional[torch.Tensor] = None,  # (B,) int32
    return_lse: bool = False,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[Union[int, torch.Tensor]] = None,
):
    """(B, T, Hq, D) attention output, and (B * Hq, T) f32 lse when
    `return_lse`. CPU tensors take the plain version; CUDA tensors (bf16,
    contiguous, D 64 or 128, int32 lengths) launch the kernel and count
    the launch in `flash_attention.launches`."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, causal, kv_lengths, return_lse,
                                     dropout_rate, dropout_seed)
    return _launch(q, k, v, scale, causal, kv_lengths, return_lse, dropout_rate, dropout_seed)


flash_attention.launches = 0
