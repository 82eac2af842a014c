"""Normalisation ops with f32 accumulation (port of `omni_avsr_tpu/ops/norms.py`)."""

from __future__ import annotations

from typing import Optional

import torch


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim, computed in f32 and cast back."""
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """HF Llama RMSNorm: f32 variance, cast back, THEN scale by the weight."""
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + eps)).to(dtype)
    return y * weight.to(dtype)


def batch_norm_inference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode BatchNorm over the last (channel) axis, f32 math."""
    inv = torch.rsqrt(var.float() + eps)
    scale_f = scale.float() * inv
    bias_f = bias.float() - mean.float() * scale.float() * inv
    return (x.float() * scale_f + bias_f).to(x.dtype)
