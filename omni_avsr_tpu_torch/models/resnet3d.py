"""ResNet3D video frontend, eval mode (port of
`omni_avsr_tpu/models/resnet3d.py`; AV-HuBERT's `ResEncoder`,
`av_hubert/avhubert/resnet.py:35-169`).

Conv3d(1->64, k=(5,7,7), s=(1,2,2)) + BN + PReLU + MaxPool3d(k=(1,3,3),
s=(1,2,2)) -> ResNet-18 trunk (BasicBlock x [2,2,2,2], PReLU) -> global
average pool -> (B, T, 512). Channel-last layouts as in the JAX package;
BatchNorms use their running statistics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.conv_block import bn_fold, reference_conv
from ..ops.norms import batch_norm_inference
from .common import Params


def _prelu_vec(p: Params, name: str, cout: int, device) -> torch.Tensor:
    """PReLU slope vector; the relu_type='relu' variant is PReLU with a=0."""
    return p[name] if name in p else torch.zeros((cout,), device=device)


def _basic_block(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    cout = p["conv1"]["w"].shape[-1]
    a1 = _prelu_vec(p, "prelu1", cout, x.device)
    a2 = _prelu_vec(p, "prelu2", cout, x.device)
    residual = x
    if "downsample" in p:
        sd, bd = bn_fold(p["downsample"]["bn"])
        residual = reference_conv(x, p["downsample"]["conv"]["w"], stride, 0, scale=sd, bias=bd)
    s1, b1 = bn_fold(p["bn1"])
    h = reference_conv(x, p["conv1"]["w"], stride, 1, scale=s1, bias=b1, prelu_a=a1)
    s2, b2 = bn_fold(p["bn2"])
    return reference_conv(h, p["conv2"]["w"], 1, 1, scale=s2, bias=b2, prelu_a=a2,
                          residual=residual)


def stem_pool(params: Params, video: torch.Tensor) -> torch.Tensor:
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
    x = batch_norm_inference(x, bn["scale"], bn["bias"], bn["mean"], bn["var"])
    if "prelu" in stem:
        a = stem["prelu"].to(x.dtype)
        x = torch.clamp(x, min=0) + a * torch.clamp(x, max=0)
    else:
        x = torch.relu(x)
    _, Tn, Hn, Wn, Cn = x.shape
    x = x.reshape(B * Tn, Hn, Wn, Cn).permute(0, 3, 1, 2)
    x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
    return x.permute(0, 2, 3, 1)


def resnet3d_forward(params: Params, video: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, 1) -> per-frame features (B, T, 512)."""
    B, T = video.shape[:2]
    x = stem_pool(params, video)
    for name in ("layer1", "layer2", "layer3", "layer4"):
        stride = 1 if name == "layer1" else 2
        x = _basic_block(params[name]["b0"], x, stride)
        x = _basic_block(params[name]["b1"], x, 1)
    x = x.float().mean(dim=(1, 2)).to(x.dtype)  # AdaptiveAvgPool2d(1)
    return x.reshape(B, T, -1)
