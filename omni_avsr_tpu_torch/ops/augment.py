"""Preprocessing, batched on the device (port of
`omni_avsr_tpu/ops/augment.py`; reference `datamodule/transforms.py:29-131`):

  video train: /255 -> RandomCrop(88) -> Grayscale(luma) ->
               AdaptiveTimeMask(10, 25) -> Normalize(0.421, 0.165)
  video eval : /255 -> CenterCrop(88) -> Grayscale -> Normalize
  audio train: AdaptiveTimeMask(6400, 16000) -> AddNoise(babble, random SNR)
               -> per-utterance layer_norm(eps 1e-8)
  audio eval : [AddNoise(babble, fixed SNR)] -> per-utterance layer_norm
  pre-training video: /255 -> RandomCrop(88) -> Grayscale -> HorizontalFlip
               -> Normalize (eval: CenterCrop, no flip)

Every random draw comes from an explicit source, `rng`: a threefry key
(`utils/prng.py`), split at every site in the JAX package's order (e.g.
`k_t, k_e, k_s = split(rng, 3)` in `adaptive_time_mask`), which draws
the JAX package's bits under its `OMNI_PRNG=threefry`; or a
`torch.Generator`, whose draws land on its device and agree with the JAX
package in distribution, not value for value (its default hardware-PRNG
streams are no more reproducible across implementations).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from ..parallel.collectives import draw_rows
from ..utils import prng

SNR_CHOICES = (-5.0, 0.0, 5.0, 10.0, 15.0, 20.0, 999999.0)

# a threefry key ((2,) tensor, `utils/prng.py`) or a torch.Generator
Rng = Union[torch.Tensor, torch.Generator]


def is_key(rng) -> bool:
    """Whether `rng` is a threefry key rather than a torch.Generator."""
    return isinstance(rng, torch.Tensor)


def subkeys(rng: Rng, n: int) -> List[Rng]:
    """`jax.random.split(rng, n)` for a key; a generator n times, which
    then draws in the same order."""
    return list(prng.split(rng, n)) if is_key(rng) else [rng] * n


def _randint(rng: Rng, low: int, high: int, shape, device) -> torch.Tensor:
    """A draw whose leading axis is the batch (`draw_rows`: inside a
    data-parallel step, the global batch's draw sliced to this rank's rows)."""
    if is_key(rng):
        return draw_rows(lambda sh: prng.randint(rng, sh, low, high, device).long(), shape)
    return draw_rows(lambda sh: torch.randint(low, high, sh, generator=rng,
                                              device=rng.device).to(device), shape)


def _rand(rng: Rng, shape, device) -> torch.Tensor:
    if is_key(rng):
        return draw_rows(lambda sh: prng.uniform(rng, sh, device), shape)
    return draw_rows(lambda sh: torch.rand(sh, generator=rng, device=rng.device).to(device),
                     shape)


def utterance_layer_norm(x: torch.Tensor, lengths: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    B, S = x.shape
    valid = (torch.arange(S, device=x.device)[None, :] < lengths[:, None]).float()
    n = torch.clamp(valid.sum(dim=1, keepdim=True), min=1.0)
    xf = x.float() * valid
    mean = xf.sum(dim=1, keepdim=True) / n
    var = ((xf - mean).square() * valid).sum(dim=1, keepdim=True) / n
    return ((xf - mean) * torch.rsqrt(var + eps) * valid).to(x.dtype)


def adaptive_time_mask(rng: Rng, x: torch.Tensor, lengths: torch.Tensor,
                       window: int, stride: int, max_masks: int) -> torch.Tensor:
    """Batched AdaptiveTimeMask (`transforms.py:37-57`): n = int((len +
    stride - 0.1) // stride) masks per sample, each of width ~U[0, window)
    at a start ~U[0, len - t), t ~U[0, window) drawn apart from the width
    as the reference does; zeroes the time axis (dim 1) under the masks.
    `max_masks` must be >= (T + stride) / stride."""
    B, T = x.shape[:2]
    dev = x.device
    k_t, k_e, k_s = subkeys(rng, 3)
    n_mask = torch.floor((lengths.float() + stride - 0.1) / stride).long()
    bounds = _randint(k_t, 0, window, (B, max_masks), dev)
    widths = _randint(k_e, 0, window, (B, max_masks), dev)
    u = _rand(k_s, (B, max_masks), dev)
    span = torch.clamp(lengths[:, None].long() - bounds, min=1)
    starts = (u * span.float()).long()
    active = torch.arange(max_masks, device=dev)[None, :] < n_mask[:, None]
    idx = torch.arange(T, device=dev)[None, None, :]
    covered = ((idx >= starts[:, :, None]) & (idx < (starts + widths)[:, :, None])
               & active[:, :, None])  # (B, M, T)
    keep = ~covered.any(dim=1)
    return x * keep.reshape(B, T, *([1] * (x.dim() - 2))).to(x.dtype)


def add_noise_snr(rng: Rng, speech: torch.Tensor, lengths: torch.Tensor,
                  noise_bank: torch.Tensor, snr_db: torch.Tensor) -> torch.Tensor:
    """Mix a random segment of `noise_bank` (N,) into the valid region of
    each (B, S) waveform at the per-sample SNR `snr_db` (B,): scaled so that
    10 log10(E_speech / E_noise) = snr (torchaudio add_noise)."""
    B, S = speech.shape
    N = noise_bank.shape[0]
    dev = speech.device
    offsets = _randint(subkeys(rng, 1)[0], 0, max(N - S, 1), (B,), dev)
    idx = offsets[:, None] + torch.arange(S, device=dev)[None, :]
    noise = noise_bank.to(dev)[torch.clamp(idx, 0, N - 1)]
    valid = (torch.arange(S, device=dev)[None, :] < lengths[:, None]).float()
    sp = speech.float() * valid
    nz = noise.float() * valid
    e_speech = sp.square().sum(dim=1)
    e_noise = torch.clamp(nz.square().sum(dim=1), min=1e-10)
    scale = torch.sqrt(e_speech / (e_noise * torch.pow(10.0, snr_db.float() / 10.0)))
    return (sp + scale[:, None] * nz).to(speech.dtype) * valid


def crop_video(rng: Optional[Rng], video: torch.Tensor, out_size: int = 88,
               train: bool = False) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T, out, out, C): RandomCrop with one offset per
    sample (train) or CenterCrop (eval)."""
    B, T, H, W, C = video.shape
    if not train:
        oh, ow = (H - out_size) // 2, (W - out_size) // 2
        return video[:, :, oh:oh + out_size, ow:ow + out_size]
    dev = video.device
    kh, kw = subkeys(rng, 2)
    oh = _randint(kh, 0, H - out_size + 1, (B,), dev)
    ow = _randint(kw, 0, W - out_size + 1, (B,), dev)
    rows = oh[:, None] + torch.arange(out_size, device=dev)[None, :]  # (B, out)
    cols = ow[:, None] + torch.arange(out_size, device=dev)[None, :]
    b = torch.arange(B, device=dev)[:, None, None]
    x = video.permute(0, 2, 3, 1, 4)[b, rows[:, :, None], cols[:, None, :]]  # (B, out, out, T, C)
    return x.permute(0, 3, 1, 2, 4)


def grayscale_luma(video: torch.Tensor) -> torch.Tensor:
    """torchvision Grayscale: 0.299 R + 0.587 G + 0.114 B over the last axis."""
    if video.shape[-1] == 1:
        return video
    w = torch.tensor([0.299, 0.587, 0.114], dtype=video.dtype, device=video.device)
    return (video @ w)[..., None]


def horizontal_flip(rng: Rng, video: torch.Tensor, p: float = 0.5) -> torch.Tensor:
    """Whole-clip horizontal flip of each sample with probability p
    (`av_hubert/avhubert/utils.py:122-139`); the pre-training pipeline's."""
    flip = _rand(rng, (video.shape[0],), video.device) < p
    return torch.where(flip[:, None, None, None, None], video.flip(3), video)


def pretrain_video_pipeline(video_u8: torch.Tensor, train: bool = False,
                            generator: Optional[Rng] = None, mean: float = 0.421,
                            std: float = 0.165, flip_p: float = 0.5) -> torch.Tensor:
    """AV-HuBERT pre-training's image transform (`hubert_dataset.py:216-225`):
    /255 -> RandomCrop(88) -> Grayscale -> HorizontalFlip(flip_p) ->
    Normalize in train mode, CenterCrop and no flip in eval; unlike the
    fine-tune `video_pipeline`, no time mask. The crop offsets and flips
    come from `generator` (a threefry key: `k_crop, k_flip = split(key)`,
    or a torch.Generator)."""
    k_crop, k_flip = subkeys(generator, 2) if train else (None, None)
    x = video_u8.float() / 255.0
    x = grayscale_luma(crop_video(k_crop, x, 88, train))
    if train:
        x = horizontal_flip(k_flip, x, flip_p)
    return (x - mean) / std


def video_pipeline(video_u8: torch.Tensor, lengths: torch.Tensor, train: bool = False,
                   generator: Optional[Rng] = None, mean: float = 0.421,
                   std: float = 0.165, mask_window: int = 10,
                   mask_stride: int = 25) -> torch.Tensor:
    """(B, T, H, W, C) uint8 -> (B, T, 88, 88, 1) f32. Train mode draws the
    crop offsets and the time masks (over each clip's `lengths`) from
    `generator`, a torch.Generator or a threefry key (`k_crop, k_mask =
    split(key)`)."""
    k_crop, k_mask = subkeys(generator, 2) if train else (None, None)
    x = video_u8.float() / 255.0
    x = grayscale_luma(crop_video(k_crop, x, 88, train))
    if train:
        T = x.shape[1]
        max_masks = (T + mask_stride) // mask_stride + 1
        x = adaptive_time_mask(k_mask, x, lengths, mask_window, mask_stride, max_masks)
    return (x - mean) / std


def audio_pipeline(audio: torch.Tensor, lengths: torch.Tensor, train: bool = False,
                   generator: Optional[Rng] = None,
                   noise_bank: Optional[torch.Tensor] = None,
                   snr_target: Optional[float] = None,
                   snr_choices: Sequence[float] = SNR_CHOICES, mask_window: int = 6400,
                   mask_stride: int = 16000) -> torch.Tensor:
    """(B, S) -> per-utterance standardised waveform. Train mode masks time
    spans and, given a noise bank, mixes babble at an SNR drawn from
    `snr_choices` per sample, all from `generator` (a torch.Generator, or a
    threefry key: `k_mask, k_snr, k_noise = split(key, 3)`). Eval mode with
    a noise bank and `snr_target` below 999998 (the clean choice) mixes it
    at that fixed SNR, the reference's noise-robustness evaluation, its
    offsets drawn from `generator` (the key `PRNGKey(0)` without one, as
    the JAX package draws them)."""
    B, S = audio.shape
    x = audio
    if train:
        k_mask, k_snr, k_noise = subkeys(generator, 3)
        max_masks = (S + mask_stride) // mask_stride + 1
        x = adaptive_time_mask(k_mask, x[..., None], lengths, mask_window, mask_stride,
                               max_masks)[..., 0]
        if noise_bank is not None:
            pick = _randint(k_snr, 0, len(snr_choices), (B,), x.device)
            snr = torch.tensor(snr_choices, device=x.device)[pick]
            x = add_noise_snr(k_noise, x, lengths, noise_bank, snr)
    elif snr_target is not None and snr_target < 999998 and noise_bank is not None:
        snr = torch.full((B,), float(snr_target), device=x.device)
        x = add_noise_snr(generator if generator is not None else prng.PRNGKey(0), x, lengths,
                          noise_bank, snr)
    return utterance_layer_norm(x, lengths)
