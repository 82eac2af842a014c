"""Lightweight and dynamic convolutions (Pay Less Attention, Wu et al.
2019): the port of `omni_avsr_tpu/ops/lightconv.py`.

Batch-major (B, T, C) tensors; the semantics are fairseq's
`_forward_unfolded` (`LightweightConv1dTBC`, `DynamicConv1dTBC`):
output[t] sees x[t - padding_l .. t - padding_l + K - 1], zeros outside;
`weight_softmax` normalises the K taps; channels share taps in H head
groups of C // H consecutive channels; the dynamic taps are predicted per
(batch, time, head) from the query by one linear map, with the softmax
over the full kernel before the K > T causal truncation. Products
accumulate in f32 (f64 for f64 inputs, which the tests' gradient check
and the card's float64 reference use) and the output takes the input's
dtype.

The JAX package computes these in XLA (no `pallas_call`), and so does the
port in plain torch ops: the K shifted slices of the input, then one
`einsum`. This is no kernel and has no row in the kernel table; it runs on
whatever device its tensors are on. Neither package's serving or training
path calls it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _unfold(x: torch.Tensor, K: int, padding_l: int) -> torch.Tensor:
    """(B, T, C) -> (B, T, K, C): window k holds x[t - padding_l + k], zero
    outside (fairseq `modules/unfold.py::unfold1d`)."""
    T = x.shape[1]
    pad_r = max(K - 1 - padding_l, 0)  # padding_l > K - 1 never reads right
    xp = F.pad(x, (0, 0, padding_l, pad_r))
    return torch.stack([xp[:, k:k + T] for k in range(K)], dim=2)


def _acc(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _heads(C: int, H: int) -> int:
    if C % H:
        raise ValueError(f"channels {C} not divisible by {H} heads")
    return C // H


def lightweight_conv(
    x: torch.Tensor,  # (B, T, C)
    weight: torch.Tensor,  # (H, K): heads share taps over C // H channel groups
    padding_l: int,
    weight_softmax: bool = False,
    bias: Optional[torch.Tensor] = None,  # (C,)
) -> torch.Tensor:
    """LightweightConv1dTBC's forward, batch-major."""
    H, K = weight.shape
    R = _heads(x.shape[2], H)
    acc = _acc(x)
    w = weight.to(acc)
    if weight_softmax:
        w = torch.softmax(w, dim=-1)
    xu = _unfold(x, K, padding_l).to(acc)  # (B, T, K, C)
    y = torch.einsum("btkc,ck->btc", xu, w.repeat_interleave(R, dim=0))
    if bias is not None:
        y = y + bias.to(acc)
    return y.to(x.dtype)


def dynamic_conv(
    x: torch.Tensor,  # (B, T, C)
    query: torch.Tensor,  # (B, T, C), as a rule x itself
    weight_linear: torch.Tensor,  # (C, H * K): the taps' prediction
    num_heads: int,
    kernel_size: int,
    padding_l: int,
    weight_softmax: bool = True,
    linear_bias: Optional[torch.Tensor] = None,  # (H * K,)
    conv_bias: Optional[torch.Tensor] = None,  # (C,)
) -> torch.Tensor:
    """DynamicConv1dTBC's `_forward_unfolded`, batch-major: taps per
    (b, t, head) from the query, the softmax over the whole kernel before
    the K > T truncation, in the reference's order."""
    B, T, C = x.shape
    H, K = num_heads, kernel_size
    R = _heads(C, H)
    acc = _acc(x)
    wt = query.to(acc) @ weight_linear.to(acc)
    if linear_bias is not None:
        wt = wt + linear_bias.to(acc)
    wt = wt.reshape(B, T, H, K)
    if weight_softmax:
        wt = torch.softmax(wt, dim=-1)
    if K > T and padding_l == K - 1:  # a causal kernel longer than the sequence: the last T taps
        wt = wt[..., K - T:]
        K, padding_l = T, T - 1
    xu = _unfold(x, K, padding_l).to(acc).reshape(B, T, K, H, R)
    y = torch.einsum("btkhr,bthk->bthr", xu, wt).reshape(B, T, C)
    if conv_bias is not None:
        y = y + conv_bias.to(acc)
    return y.to(x.dtype)
