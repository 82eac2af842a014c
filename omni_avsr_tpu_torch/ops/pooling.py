"""Matryoshka token compression (port of `omni_avsr_tpu/ops/pooling.py`;
reference `modeling_OmniAVSR.py:461-606`): non-overlapping average pooling
or frame stacking over time, remainder frames dropped."""

from __future__ import annotations

import torch


def compressed_len(T: int, rate: int) -> int:
    """Frames left after compressing T frames at `rate` (the remainder
    dropped)."""
    return T // rate


def avg_pool_time(x: torch.Tensor, rate: int) -> torch.Tensor:
    """(B, T, D) -> (B, T//rate, D), mean (accumulated in f32) per window."""
    if rate == 1:
        return x
    B, T, D = x.shape
    Tc = (T // rate) * rate
    return x[:, :Tc].float().reshape(B, T // rate, rate, D).mean(dim=2).to(x.dtype)


def stack_time(x: torch.Tensor, rate: int) -> torch.Tensor:
    """(B, T, D) -> (B, T//rate, rate*D)."""
    if rate == 1:
        return x
    B, T, D = x.shape
    Tc = (T // rate) * rate
    return x[:, :Tc].reshape(B, T // rate, rate * D)


def compress(x: torch.Tensor, rate: int, mode: str) -> torch.Tensor:
    if mode == "avg-pooling":
        return avg_pool_time(x, rate)
    if mode == "stack":
        return stack_time(x, rate)
    raise ValueError(f"unknown compression mode: {mode}")
