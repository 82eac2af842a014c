"""Rotary position embeddings, plain and Llama-3 frequency-scaled
(port of `omni_avsr_tpu/ops/rope.py`; HF `LlamaRotaryEmbedding` numerics)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import LLMConfig


def inv_freq(cfg: LLMConfig) -> np.ndarray:
    """Per-dim inverse frequencies (float64 math, f32 result), with the
    llama3 rescale (HF `_compute_llama3_parameters`)."""
    head_dim = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    if cfg.rope_scaling_factor is not None:
        factor = cfg.rope_scaling_factor
        low = cfg.rope_low_freq_factor
        high = cfg.rope_high_freq_factor
        orig = cfg.rope_original_max_position
        low_wavelen = orig / low
        high_wavelen = orig / high
        wavelen = 2.0 * np.pi / inv
        inv_scaled = np.where(wavelen > low_wavelen, inv / factor, inv)
        smooth = (orig / wavelen - low) / (high - low)
        smoothed = (1.0 - smooth) / factor * inv + smooth * inv
        is_medium = (wavelen >= high_wavelen) & (wavelen <= low_wavelen)
        inv = np.where(is_medium, smoothed, inv_scaled)
    return inv.astype(np.float32)


def rope_cos_sin(cfg: LLMConfig, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 cos/sin tables for integer positions of any shape -> (*pos, head_dim),
    angles repeated as [f0..f{d/2-1}, f0..f{d/2-1}]."""
    inv = torch.from_numpy(inv_freq(cfg)).to(positions.device)
    freqs = positions.float()[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """q/k: (..., T, H, D); cos/sin: (..., T, D), broadcast over heads and
    applied in the compute dtype."""
    cos_b = cos[..., :, None, :].to(q.dtype)
    sin_b = sin[..., :, None, :].to(q.dtype)
    return q * cos_b + _rotate_half(q) * sin_b, k * cos_b + _rotate_half(k) * sin_b
