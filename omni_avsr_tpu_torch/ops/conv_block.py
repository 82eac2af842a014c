"""Conv + folded BN + residual + PReLU for the ResNet trunk, eval mode
(port of `bn_fold` and `_reference_conv` of `omni_avsr_tpu/ops/conv_block.py`).

The JAX package's Pallas conv kernel is an opt-in experiment
(`OMNI_CONV_KERNEL=1`) that its eval path does not run; this is the plain
route it falls back to: the conv in the input dtype, the epilogue in f32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def bn_fold(p: Dict[str, torch.Tensor], eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frozen BN running stats -> per-channel (scale, bias) affine in f32."""
    inv = torch.rsqrt(p["var"].float() + eps)
    scale = p["scale"].float() * inv
    bias = p["bias"].float() - p["mean"].float() * scale
    return scale, bias


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    """x (N, H, W, Cin), w (kh, kw, Cin, Cout) in the JAX "HWIO" layout."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def reference_conv(
    x: torch.Tensor,
    w: torch.Tensor,
    stride: int,
    pad: int,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    prelu_a: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """conv -> BN affine -> + residual -> PReLU, epilogue in f32, result in
    x's dtype (the BasicBlock order, `resnet.py:35-60`)."""
    y = conv2d_nhwc(x, w, stride, pad).float()
    if scale is not None:
        y = y * scale.float() + bias.float()
    if residual is not None:
        y = y + residual.float()
    if prelu_a is not None:
        a = prelu_a.float()
        y = torch.clamp(y, min=0.0) + a * torch.clamp(y, max=0.0)
    return y.to(x.dtype)
