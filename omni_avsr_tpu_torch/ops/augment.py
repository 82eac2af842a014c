"""Eval-mode preprocessing, batched on the device (the eval branches of
`omni_avsr_tpu/ops/augment.py:169-221`; reference
`datamodule/transforms.py:29-131`):

  video: /255 -> CenterCrop(88) -> Grayscale(luma) -> Normalize(0.421, 0.165)
  audio: per-utterance layer_norm over the valid region (eps 1e-8)

Training augmentation (random crop, time masks, noise) is not ported.
"""

from __future__ import annotations

import torch


def utterance_layer_norm(x: torch.Tensor, lengths: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    B, S = x.shape
    valid = (torch.arange(S, device=x.device)[None, :] < lengths[:, None]).float()
    n = torch.clamp(valid.sum(dim=1, keepdim=True), min=1.0)
    xf = x.float() * valid
    mean = xf.sum(dim=1, keepdim=True) / n
    var = ((xf - mean).square() * valid).sum(dim=1, keepdim=True) / n
    return ((xf - mean) * torch.rsqrt(var + eps) * valid).to(x.dtype)


def center_crop(video: torch.Tensor, out_size: int = 88) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T, out, out, C)."""
    H, W = video.shape[2:4]
    oh, ow = (H - out_size) // 2, (W - out_size) // 2
    return video[:, :, oh:oh + out_size, ow:ow + out_size]


def grayscale_luma(video: torch.Tensor) -> torch.Tensor:
    """torchvision Grayscale: 0.299 R + 0.587 G + 0.114 B over the last axis."""
    if video.shape[-1] == 1:
        return video
    w = torch.tensor([0.299, 0.587, 0.114], dtype=video.dtype, device=video.device)
    return (video @ w)[..., None]


def video_pipeline(video_u8: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) uint8 -> (B, T, 88, 88, 1) f32, eval mode. `lengths`
    matches the JAX signature; only the training time masks read it."""
    x = video_u8.float() / 255.0
    x = grayscale_luma(center_crop(x, 88))
    return (x - 0.421) / 0.165


def audio_pipeline(audio: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, S) -> per-utterance standardised waveform, eval mode without noise."""
    return utterance_layer_norm(audio, lengths)
