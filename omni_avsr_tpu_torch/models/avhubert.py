"""AV-HuBERT encoder, the video tower, with its LoRA (port of
`omni_avsr_tpu/models/avhubert.py`; reference
`av_hubert/avhubert/hubert.py:318-789` and the patched fairseq encoder):

  video (B,T,88,88,1) -> ResNet3D -> Linear(512->D); audio half zero-filled
  concat (B,T,2D) -> LayerNorm -> post_extract_proj (2D->D)
  -> + pos-conv (grouped k=128, SamePad trim, GELU)
  -> N pre-LN layers, LoRA deltas on q/v (scaling 2) -> final LayerNorm

Serving passes no lengths, as the reference's `extract_finetune` call
(`modeling_OmniAVSR.py:463`) passes no padding mask; with `lengths` the
keys past each clip's length are masked.

Train mode (`train_mode=True`, `:111-250`) runs the ResNet's BatchNorms on
batch statistics; a `generator` adds fairseq's train()-mode stochastics,
all drawn from it: input dropout, dropout after the attention and the
second FFN linear, and layerdrop (layer i runs iff its uniform draw
u_i > layerdrop; a dropped layer is skipped, which is fairseq's behaviour
and gives what the JAX package's select gives). Attention: on the card, at
T >= FLASH_MIN_T_TRAIN with head dim 64 or 128, the trainable flash
kernels (B3 forward, B4 backward) with the lengths as `kv_lengths` and the
attention dropout inside the kernels under an int32 seed drawn from the
generator, as the JAX package routes it on the TPU (`:146-164`); otherwise,
and on the CPU, the plain `dot_product_attention` with a padding mask and
generator dropout.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import AVHubertConfig
from ..ops.attention import FLASH_MIN_T_TRAIN, dot_product_attention, padding_mask_from_lengths
from ..ops.flash_attention_bwd import flash_attention_trainable
from ..ops.norms import layer_norm
from .common import Params, layer_slice, linear
from .resnet3d import resnet3d_forward
from .whisper import conv1d_nwc


def _pos_conv(x: torch.Tensor, p: Params, cfg: AVHubertConfig) -> torch.Tensor:
    """Grouped conv positional encoding; the even kernel's SamePad trims the
    final step (`wav2vec2.py:826-840`)."""
    y = conv1d_nwc(x, p["w"], p["b"], 1, cfg.conv_pos // 2, groups=cfg.conv_pos_groups)
    return F.gelu(y[:, :-1])


def _dropout(generator: Optional[torch.Generator], x: torch.Tensor, rate: float) -> torch.Tensor:
    """x * Bernoulli(1 - rate) / (1 - rate), the mask drawn from `generator`;
    the identity without one."""
    if generator is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=generator.device) < 1.0 - rate
    return x * keep.to(device=x.device, dtype=x.dtype) / (1.0 - rate)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: Optional[torch.Tensor],
               cfg: AVHubertConfig, generator: Optional[torch.Generator],
               seed: Optional[int]) -> torch.Tensor:
    T, hd = q.shape[1], q.shape[3]
    rate = cfg.attention_dropout if generator is not None else 0.0
    if q.is_cuda and T >= FLASH_MIN_T_TRAIN and hd in (64, 128):
        lens = lengths.to(torch.int32).contiguous() if lengths is not None else None
        return flash_attention_trainable(q, k, v, kv_lengths=lens, dropout_rate=rate,
                                         dropout_seed=seed if rate > 0.0 else None)
    mask = None
    if lengths is not None:
        mask = padding_mask_from_lengths(lengths, k.shape[1])[:, None, None, :]
    return dot_product_attention(q, k, v, mask=mask, dropout_rate=rate, generator=generator)


def _encoder_layer(layer: Params, cfg: AVHubertConfig, x: torch.Tensor,
                   lengths: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   seed: Optional[int] = None) -> torch.Tensor:
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
                     lengths, cfg, generator, seed)
    x = x + _dropout(generator, linear(out.reshape(B, T, D), attn["o"]), cfg.dropout)
    h = layer_norm(x, layer["final_norm"]["scale"], layer["final_norm"]["bias"])
    h = _dropout(generator, F.gelu(linear(h, layer["fc1"])), cfg.activation_dropout)
    return x + _dropout(generator, linear(h, layer["fc2"]), cfg.dropout)


def avhubert_extract_features(params: Params, cfg: AVHubertConfig, video: torch.Tensor,
                              train_mode: bool = False, conv_kernel: bool = False) -> torch.Tensor:
    """Video features, zero-filled audio half, concat fuse (`hubert.py:695-728`);
    `conv_kernel` runs the ResNet trunk's convs through B7."""
    vf = resnet3d_forward(params["video_frontend"], video, train_mode, conv_kernel)
    vfeat = linear(vf, params["video_proj"])
    afeat = torch.zeros_like(vfeat)
    if cfg.modality_fuse == "concat":
        feats = torch.cat([afeat, vfeat], dim=-1)  # audio first (`hubert.py:714`)
    else:
        feats = afeat + vfeat
    fn = params["fuse_norm"]
    feats = layer_norm(feats, fn["scale"], fn["bias"])
    return linear(feats, params["post_extract_proj"])


def layers_to_run(cfg: AVHubertConfig, generator: Optional[torch.Generator]):
    """(indices of the encoder layers to run, one int32 attention-dropout
    seed per layer): every layer and no seeds without a generator; else
    layerdrop's uniform draws and the seeds, from one draw of the
    generator (one host sync)."""
    L = cfg.encoder_layers
    if generator is None:
        return list(range(L)), [None] * L
    draws = torch.randint(0, 2**31 - 1, (2, L), generator=generator,
                          device=generator.device).tolist()
    keep = [i for i in range(L) if draws[0][i] / 2**31 > cfg.layerdrop]
    return keep, draws[1]


def avhubert_encode(params: Params, cfg: AVHubertConfig, video: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None, train_mode: bool = False,
                    generator: Optional[torch.Generator] = None,
                    plan: Optional[Tuple[List[int], List[Optional[int]]]] = None,
                    conv_kernel: bool = False) -> torch.Tensor:
    """`extract_finetune` over video only: (B, T, D); `lengths` (B,) masks
    each clip's padded frames as keys. `plan` is `layers_to_run`'s (layers,
    seeds), drawn here from `generator` when not given. `conv_kernel` runs
    the ResNet trunk's convs through B7."""
    assert cfg.layer_norm_first, "the post-LN variant is not ported"
    keep, seeds = plan if plan is not None else layers_to_run(cfg, generator)
    feats = avhubert_extract_features(params, cfg, video, train_mode, conv_kernel)
    feats = _dropout(generator, feats, cfg.dropout_input)
    x = feats + _pos_conv(feats, params["pos_conv"], cfg)
    x = _dropout(generator, x, cfg.dropout)
    for i in keep:
        x = _encoder_layer(layer_slice(params["layers"], i), cfg, x, lengths, generator, seeds[i])
    tn = params["top_norm"]
    return layer_norm(x, tn["scale"], tn["bias"])
