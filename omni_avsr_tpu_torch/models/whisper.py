"""Whisper encoder, the audio tower (port of `omni_avsr_tpu/models/whisper.py`;
HF `WhisperModel.encoder`, used at `Omni_AVSR/modeling_OmniAVSR.py:59-62`):

  mel (B, F, 80) -> gelu(conv1d k3 s1 p1) -> gelu(conv1d k3 s2 p1)
  -> + sinusoidal positions -> N pre-LN layers -> final LayerNorm

Attention: on the card, at T >= 512 with head dim 64 or 128 (the 30 s
window gives T = 1500), the flash kernel B3, as the JAX package routes it
on the TPU (`omni_avsr_tpu/models/whisper.py:104`); otherwise, and on the
CPU, the plain `dot_product_attention`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import WhisperEncoderConfig
from ..ops.attention import dot_product_attention
from ..ops.flash_attention import flash_attention
from ..ops.norms import layer_norm
from .common import Params, layer_slice, linear, tp_ffn


def sinusoidal_positions(length: int, channels: int) -> np.ndarray:
    """Whisper's sinusoid table (log-spaced, [sin | cos] concat)."""
    log_timescale_increment = np.log(10000.0) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(np.float32)


def conv1d_nwc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int, pad: int,
               groups: int = 1) -> torch.Tensor:
    """x (B, T, Cin), w (K, Cin/groups, Cout) in the JAX "WIO" layout."""
    y = F.conv1d(x.transpose(1, 2), w.to(x.dtype).permute(2, 1, 0), stride=stride,
                 padding=pad, groups=groups)
    return y.transpose(1, 2) + b.to(x.dtype)


FLASH_MIN_T = 512  # the JAX tower's gate for the flash kernel


def _encoder_layer(layer: Params, cfg: WhisperEncoderConfig, x: torch.Tensor) -> torch.Tensor:
    B, T, D = x.shape
    H = cfg.num_heads
    hd = D // H
    h = layer_norm(x, layer["attn_norm"]["scale"], layer["attn_norm"]["bias"], cfg.layer_norm_eps)
    attn = layer["attn"]
    q = linear(h, attn["q"]).reshape(B, T, H, hd)
    k = linear(h, attn["k"]).reshape(B, T, H, hd)
    v = linear(h, attn["v"]).reshape(B, T, H, hd)
    if x.is_cuda and T >= FLASH_MIN_T and hd in (64, 128):
        out = flash_attention(q, k, v)
    else:
        out = dot_product_attention(q, k, v)
    x = x + linear(out.reshape(B, T, D), attn["o"])
    h = layer_norm(x, layer["mlp_norm"]["scale"], layer["mlp_norm"]["bias"], cfg.layer_norm_eps)
    return x + tp_ffn(h, layer["fc1"], layer["fc2"], "whisper.ffn", F.gelu)


def whisper_encode(params: Params, cfg: WhisperEncoderConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, F, n_mels) -> (B, F/2, D) hidden states."""
    x = F.gelu(conv1d_nwc(mel, params["conv1"]["w"], params["conv1"]["b"], 1, 1))
    x = F.gelu(conv1d_nwc(x, params["conv2"]["w"], params["conv2"]["b"], 2, 1))
    T = x.shape[1]
    x = x + params["pos_embed"][:T].to(x.dtype)
    for i in range(cfg.num_layers):
        x = _encoder_layer(layer_slice(params["layers"], i), cfg, x)
    fn = params["final_norm"]
    return layer_norm(x, fn["scale"], fn["bias"], cfg.layer_norm_eps)
