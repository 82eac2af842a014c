"""AV-HuBERT encoder, the video tower, in eval mode with its LoRA
(port of `omni_avsr_tpu/models/avhubert.py`; reference
`av_hubert/avhubert/hubert.py:318-789` and the patched fairseq encoder):

  video (B,T,88,88,1) -> ResNet3D -> Linear(512->D); audio half zero-filled
  concat (B,T,2D) -> LayerNorm -> post_extract_proj (2D->D)
  -> + pos-conv (grouped k=128, SamePad trim, GELU)
  -> N pre-LN layers, LoRA deltas on q/v (scaling 2) -> final LayerNorm

Serving passes no lengths, as the reference's `extract_finetune` call
(`modeling_OmniAVSR.py:463`) passes no padding mask; with `lengths` the
keys past each clip's length are masked. Attention: on the card, at
T >= 256 with head dim 64 or 128, the flash kernel B3 (with the lengths as
`kv_lengths`), as the JAX package routes it on the TPU
(`omni_avsr_tpu/models/avhubert.py:146-160`); otherwise, and on the CPU,
the plain `dot_product_attention` with a padding mask. Dropout and
layerdrop are training-only and not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..config import AVHubertConfig
from ..ops.attention import dot_product_attention, padding_mask_from_lengths
from ..ops.flash_attention import flash_attention
from ..ops.norms import layer_norm
from .common import Params, layer_slice, linear
from .resnet3d import resnet3d_forward
from .whisper import conv1d_nwc


def _pos_conv(x: torch.Tensor, p: Params, cfg: AVHubertConfig) -> torch.Tensor:
    """Grouped conv positional encoding; the even kernel's SamePad trims the
    final step (`wav2vec2.py:826-840`)."""
    y = conv1d_nwc(x, p["w"], p["b"], 1, cfg.conv_pos // 2, groups=cfg.conv_pos_groups)
    return F.gelu(y[:, :-1])


FLASH_MIN_T = 256  # `FLASH_MIN_T_TRAIN` of the JAX package (`ops/attention.py:33`)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lengths: Optional[torch.Tensor]) -> torch.Tensor:
    T, hd = q.shape[1], q.shape[3]
    if q.is_cuda and T >= FLASH_MIN_T and hd in (64, 128):
        lens = lengths.to(torch.int32).contiguous() if lengths is not None else None
        return flash_attention(q, k, v, kv_lengths=lens)
    mask = None
    if lengths is not None:
        mask = padding_mask_from_lengths(lengths, k.shape[1])[:, None, None, :]
    return dot_product_attention(q, k, v, mask=mask)


def _encoder_layer(layer: Params, cfg: AVHubertConfig, x: torch.Tensor,
                   lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    B, T, D = x.shape
    H = cfg.encoder_heads
    hd = D // H
    h = layer_norm(x, layer["attn_norm"]["scale"], layer["attn_norm"]["bias"])
    attn = layer["attn"]
    q = linear(h, attn["q"])
    k = linear(h, attn["k"])
    v = linear(h, attn["v"])
    if "lora" in layer:
        lora = layer["lora"]
        q = q + linear(linear(h, lora["down_q"]), lora["up_q"]) * cfg.lora_scaling
        v = v + linear(linear(h, lora["down_v"]), lora["up_v"]) * cfg.lora_scaling
    out = _attention(q.reshape(B, T, H, hd), k.reshape(B, T, H, hd), v.reshape(B, T, H, hd),
                     lengths)
    x = x + linear(out.reshape(B, T, D), attn["o"])
    h = layer_norm(x, layer["final_norm"]["scale"], layer["final_norm"]["bias"])
    h = F.gelu(linear(h, layer["fc1"]))
    return x + linear(h, layer["fc2"])


def avhubert_extract_features(params: Params, cfg: AVHubertConfig,
                              video: torch.Tensor) -> torch.Tensor:
    """Video features, zero-filled audio half, concat fuse (`hubert.py:695-728`)."""
    vf = resnet3d_forward(params["video_frontend"], video)
    vfeat = linear(vf, params["video_proj"])
    afeat = torch.zeros_like(vfeat)
    if cfg.modality_fuse == "concat":
        feats = torch.cat([afeat, vfeat], dim=-1)  # audio first (`hubert.py:714`)
    else:
        feats = afeat + vfeat
    fn = params["fuse_norm"]
    feats = layer_norm(feats, fn["scale"], fn["bias"])
    return linear(feats, params["post_extract_proj"])


def avhubert_encode(params: Params, cfg: AVHubertConfig, video: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eval-mode `extract_finetune` over video only: (B, T, D); `lengths`
    (B,) masks each clip's padded frames as keys."""
    assert cfg.layer_norm_first, "the post-LN variant is not ported"
    feats = avhubert_extract_features(params, cfg, video)
    x = feats + _pos_conv(feats, params["pos_conv"], cfg)
    for i in range(cfg.encoder_layers):
        x = _encoder_layer(layer_slice(params["layers"], i), cfg, x, lengths)
    tn = params["top_norm"]
    return layer_norm(x, tn["scale"], tn["bias"])
