"""Flash attention backward and the trainable flash attention: the port of
the TPU kernels `_dq_kernel` and `_dkv_kernel` of
`omni_avsr_tpu/ops/flash_attention_bwd.py` (B4) and of its custom-VJP
`flash_attention_trainable` (`:245-301`).

From the forward's row logsumexp, with the forward's masks and its hash
dropout keep mask (`ops/flash_attention.py::keep_mask`):
    p  = exp(q k^T * scale - lse), 0 where masked
    dv = p_drop^T do,            p_drop = p * keep / (1 - rate)
    dp = (do v^T) * keep / (1 - rate)
    ds = p * (dp - rowsum(do * o)) * scale
    dq = ds k,  dk = ds^T q
dk and dv are summed over each kv head's GQA group. The (T x S) matrices
never reach memory on the card; there, rowsum(do * o) and the group sums
are taken inside the kernels.

`flash_attention_bwd` is the wrapper. A tensor on the CPU takes
`flash_attention_bwd_plain`, the same math densely in torch; a CUDA tensor
launches the two hand-written kernels of `csrc/flash_attention_bwd.cu`
(built with nvcc on first use) or raises. `flash_attention_trainable` is a
`torch.autograd.Function` whose forward is B3 with lse and whose backward
is B4.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Union

import torch

from ..kernels import check, load
from .flash_attention import _M32, _threshold, flash_attention, keep_mask

_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 4 \
    + [ctypes.c_float, ctypes.c_void_p]


def flash_attention_bwd_plain(
    q: torch.Tensor,  # (B, T, Hq, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,
    o: torch.Tensor,  # (B, T, Hq, D): the forward's output
    do: torch.Tensor,  # (B, T, Hq, D)
    lse: torch.Tensor,  # (B * Hq, T) f32
    causal: bool = False,
    kv_lengths: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[Union[int, torch.Tensor]] = None,
):
    """(dq, dk, dv) in the dtypes of q, k, v: the TPU kernels' math
    (`_flash_bwd`, `:144-242`) written out densely, f32 logits and sums;
    p_drop and ds are rounded to the input dtype for their products, as the
    kernels do."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    dev = q.device
    qg = q.reshape(B, T, Hkv, G, D).float()
    dog = do.reshape(B, T, Hkv, G, D).float()
    s = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) * scale  # (B, Hkv, G, T, S)
    kj = torch.arange(S, device=dev)
    valid = torch.ones((B, T, S), dtype=torch.bool, device=dev)
    if kv_lengths is not None:
        valid = valid & (kj[None, None, :] < kv_lengths.to(dev)[:, None, None])
    if causal:
        valid = valid & (kj[None, None, :] <= torch.arange(T, device=dev)[None, :, None])
    lse_g = lse.float().reshape(B, Hkv, G, T)
    zero = torch.zeros((), device=dev)
    p = torch.where(valid[:, None, None], torch.exp(s - lse_g[..., None]), zero)
    dsum = (do.float() * o.float()).sum(dim=-1).reshape(B, T, Hkv, G).permute(0, 2, 3, 1)
    dp = torch.einsum("bthgd,bshd->bhgts", dog, v.float())
    p_drop = p
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 needs a dropout_seed")
        heads = torch.arange(B * Hq, device=dev)
        keep = keep_mask(int(dropout_seed), heads, 0, 0, T, S, S, dropout_rate)
        keep = keep.reshape(B, Hkv, G, T, S)
        inv = 1.0 / (1.0 - dropout_rate)
        p_drop = torch.where(keep, p, zero) * inv
        dp = torch.where(keep, dp, zero) * inv
    dv = torch.einsum("bhgts,bthgd->bshd", p_drop.to(do.dtype).float(), dog)
    ds = p * (dp - dsum[..., None]) * scale
    dq = torch.einsum("bhgts,bshd->bthgd", ds.to(k.dtype).float(), k.float())
    dk = torch.einsum("bhgts,bthgd->bshd", ds.to(q.dtype).float(), qg)
    return dq.reshape(B, T, Hq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.lru_cache(maxsize=1)
def _launcher():
    """The kernels' C entry point, built and typed once per process."""
    fn = load("flash_attention_bwd").flash_attention_bwd_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, o, do, lse, causal, kv_lengths, scale, dropout_rate, dropout_seed):
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if D not in (64, 128):
        raise ValueError(f"head_dim {D}: the kernel takes 64 or 128")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq {Hq} not a multiple of Hkv {Hkv}")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate {dropout_rate} outside [0, 1)")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 needs a dropout_seed")
    if B * T * S == 0:
        raise ValueError(f"empty attention: B {B}, T {T}, S {S}")
    bf16 = torch.bfloat16
    for name, t in (("q", q), ("o", o), ("do", do)):
        check(name, t, (B, T, Hq, D), bf16)
    check("k", k, (B, S, Hkv, D), bf16)
    check("v", v, (B, S, Hkv, D), bf16)
    check("lse", lse, (B * Hq, T), torch.float32)
    lens_ptr = None
    if kv_lengths is not None:
        check("kv_lengths", kv_lengths, (B,), torch.int32)
        lens_ptr = kv_lengths.data_ptr()
    if len({t.device for t in (q, k, v, o, do, lse, kv_lengths) if t is not None}) != 1:
        raise ValueError("inputs on several devices")
    # the wrapper allocates and launches; rowsum(do * o) (an XLA op beside
    # the TPU kernels, `:172`) and the GQA group sums happen in the kernels
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dsum = torch.empty((B * Hq, T), dtype=torch.float32, device=q.device)
    seed = int(dropout_seed) if dropout_rate > 0.0 else 0
    seed = ((seed & _M32) ^ 2**31) - 2**31  # as a signed 32-bit int, for ctypes
    with torch.cuda.device(q.device):
        rc = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), lens_ptr, dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, T, S, Hq, Hkv, D, float(D ** -0.5 if scale is None else scale),
            int(causal), int(dropout_rate > 0.0), seed,
            _threshold(dropout_rate) if dropout_rate > 0.0 else 0,
            float(1.0 / (1.0 - dropout_rate)),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {rc}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    causal: bool = False,
    kv_lengths: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[Union[int, torch.Tensor]] = None,
):
    """(dq, dk, dv). CPU tensors take the plain version; CUDA tensors (bf16,
    contiguous, D 64 or 128, f32 lse, int32 lengths) launch the two kernels
    and nothing else, and count one launch in `flash_attention_bwd.launches`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, lse, causal, kv_lengths, scale,
                                         dropout_rate, dropout_seed)
    return _launch(q, k, v, o, do, lse, causal, kv_lengths, scale, dropout_rate, dropout_seed)


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """B3 forward with lse; B4 backward (the custom VJP of `:245-275`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, kv_lengths, dropout_rate, dropout_seed):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention(q, k, v, causal=causal, kv_lengths=kv_lengths,
                                   return_lse=True, dropout_rate=dropout_rate,
                                   dropout_seed=dropout_seed)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, kv_lengths, dropout_rate, dropout_seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, kv_lengths, rate, seed = ctx.opts
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse, causal=causal,
                                         kv_lengths=kv_lengths, dropout_rate=rate,
                                         dropout_seed=seed)
        return dq, dk, dv, None, None, None, None


def flash_attention_trainable(
    q: torch.Tensor,  # (B, T, Hq, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,
    causal: bool = False,
    kv_lengths: Optional[torch.Tensor] = None,  # (B,) int32
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,  # int32, required when dropout_rate > 0
) -> torch.Tensor:
    """Flash attention that autograd can differentiate: B3 forward, B4
    backward, the same hash dropout mask in both. Where no grad is needed
    (inference), the plain B3 call, without the lse."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 needs a dropout_seed")
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        return flash_attention(q, k, v, causal=causal, kv_lengths=kv_lengths,
                               dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    return _FlashAttention.apply(q, k, v, causal, kv_lengths, float(dropout_rate),
                                 dropout_seed)
