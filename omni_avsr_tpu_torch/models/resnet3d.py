"""ResNet3D video frontend (port of `omni_avsr_tpu/models/resnet3d.py`;
AV-HuBERT's `ResEncoder`, `av_hubert/avhubert/resnet.py:35-169`).

Conv3d(1->64, k=(5,7,7), s=(1,2,2)) + BN + PReLU + MaxPool3d(k=(1,3,3),
s=(1,2,2)) -> ResNet-18 trunk (BasicBlock x [2,2,2,2], PReLU) -> global
average pool -> (B, T, 512). Channel-last layouts as in the JAX package.
Eval mode folds the BatchNorms' running statistics into the convs; train
mode (`train_mode=True`, the reference's frozen encoder in train()) runs
them on batch statistics, one pass E[x^2] - E[x]^2 in f32 clamped at 0
(`:34-53`), and, as there, does not update the running statistics.
`conv_kernel=True` routes every trunk conv through the fused conv B7
(`ops/conv_block.py::fused_conv`), as `OMNI_CONV_KERNEL=1` does in the JAX
package: in eval mode with the folded BN, the residual and PReLU in its
epilogue (19 launches per forward), in train mode the raw convs. The stem
is not B7 there either.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.conv_block import bn_fold, fused_conv
from ..ops.norms import batch_norm_inference
from .common import Params


def _prelu_vec(p: Params, name: str, cout: int, device) -> torch.Tensor:
    """PReLU slope vector; the relu_type='relu' variant is PReLU with a=0."""
    return p[name] if name in p else torch.zeros((cout,), device=device)


def prelu(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Per-channel PReLU in x's dtype; channel is the last axis."""
    a = a.to(x.dtype)
    return torch.clamp(x, min=0) + a * torch.clamp(x, max=0)


def batch_norm_train(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm over every axis but the last with the batch's statistics."""
    axes = tuple(range(x.dim() - 1))
    xf = x.float()
    mean = xf.mean(dim=axes)
    var = torch.clamp(xf.square().mean(dim=axes) - mean.square(), min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps) * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def _basic_block(p: Params, x: torch.Tensor, stride: int, train_mode: bool = False,
                 conv_kernel: bool = False) -> torch.Tensor:
    cout = p["conv1"]["w"].shape[-1]
    a1 = _prelu_vec(p, "prelu1", cout, x.device)
    a2 = _prelu_vec(p, "prelu2", cout, x.device)
    kw = dict(use_kernel=conv_kernel)
    if train_mode:  # raw convs, BN on the batch, then the affine + PReLU epilogue
        residual = x
        if "downsample" in p:
            r = fused_conv(x, p["downsample"]["conv"]["w"], stride, 0, **kw)
            residual = batch_norm_train(r, p["downsample"]["bn"])
        h = fused_conv(x, p["conv1"]["w"], stride, 1, **kw)
        h = prelu(batch_norm_train(h, p["bn1"]), a1)
        h = batch_norm_train(fused_conv(h, p["conv2"]["w"], 1, 1, **kw), p["bn2"])
        return prelu(h + residual, a2)
    residual = x
    if "downsample" in p:
        sd, bd = bn_fold(p["downsample"]["bn"])
        residual = fused_conv(x, p["downsample"]["conv"]["w"], stride, 0, scale=sd, bias=bd, **kw)
    s1, b1 = bn_fold(p["bn1"])
    h = fused_conv(x, p["conv1"]["w"], stride, 1, scale=s1, bias=b1, prelu_a=a1, **kw)
    s2, b2 = bn_fold(p["bn2"])
    return fused_conv(h, p["conv2"]["w"], 1, 1, scale=s2, bias=b2, prelu_a=a2,
                      residual=residual, **kw)


def stem_pool(params: Params, video: torch.Tensor, train_mode: bool = False) -> torch.Tensor:
    """3D stem conv + BN + PReLU + MaxPool over (B, T, H, W, 1) frames;
    returns (B*T, H/4, W/4, 64). The stem is a Conv3d with "same" time
    padding, run in NCDHW."""
    B, T, H, W, C = video.shape
    stem = params["stem"]
    w3 = stem["conv"]["w"].to(video.dtype)  # (5, 7, 7, 1, 64) DHWIO
    x = F.conv3d(video.permute(0, 4, 1, 2, 3), w3.permute(4, 3, 0, 1, 2),
                 stride=(1, 2, 2), padding=(2, 3, 3))  # (B, 64, T, H/2, W/2)
    x = x.permute(0, 2, 3, 4, 1)  # (B, T, H/2, W/2, 64)
    bn = stem["bn"]
    if train_mode:
        x = batch_norm_train(x, bn)
    else:
        x = batch_norm_inference(x, bn["scale"], bn["bias"], bn["mean"], bn["var"])
    x = prelu(x, stem["prelu"]) if "prelu" in stem else torch.relu(x)
    _, Tn, Hn, Wn, Cn = x.shape
    x = x.reshape(B * Tn, Hn, Wn, Cn).permute(0, 3, 1, 2)
    x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
    return x.permute(0, 2, 3, 1)


def trunk_layer(params: Params, name: str, x: torch.Tensor, train_mode: bool = False,
                conv_kernel: bool = False) -> torch.Tensor:
    """One ResNet-18 layer (two BasicBlocks) over (B*T, H, W, C) frames."""
    stride = 1 if name == "layer1" else 2
    x = _basic_block(params[name]["b0"], x, stride, train_mode, conv_kernel)
    return _basic_block(params[name]["b1"], x, 1, train_mode, conv_kernel)


def resnet3d_forward(params: Params, video: torch.Tensor, train_mode: bool = False,
                     conv_kernel: bool = False) -> torch.Tensor:
    """(B, T, H, W, 1) -> per-frame features (B, T, 512)."""
    B, T = video.shape[:2]
    x = stem_pool(params, video, train_mode)
    for name in ("layer1", "layer2", "layer3", "layer4"):
        x = trunk_layer(params, name, x, train_mode, conv_kernel)
    x = x.float().mean(dim=(1, 2)).to(x.dtype)  # AdaptiveAvgPool2d(1)
    return x.reshape(B, T, -1)
