"""AV-HuBERT encoder, the video tower, with its LoRA (port of
`omni_avsr_tpu/models/avhubert.py`; reference
`av_hubert/avhubert/hubert.py:318-789` and the patched fairseq encoder):

  video (B,T,88,88,1) -> ResNet3D -> Linear(512->D)          [video features]
  audio fbank (B,T,104) -> Linear(104->D)                    [audio features]
  a missing modality zero-filled (`hubert.py:704-709`)
  concat (B,T,2D), audio first -> LayerNorm -> post_extract_proj (2D->D)
  -> + pos-conv (grouped k=128, SamePad trim, GELU)
  -> N pre-LN layers, LoRA deltas on q/v (scaling 2) -> final LayerNorm

`avhubert_encoder` is the transformer part alone, over fused features (the
pre-training loss masks them first); `output_layer` N stops after layer N
without the final LayerNorm, and `avhubert_encode(..., output_layer=0)`
returns the fused features (the unit-discovery dump,
`omni_avsr_tpu/models/avhubert.py:175-292`).

Serving passes no lengths, as the reference's `extract_finetune` call
(`modeling_OmniAVSR.py:463`) passes no padding mask; with `lengths` the
keys past each clip's length are masked.

Train mode (`train_mode=True`, `:111-250`) runs the ResNet's BatchNorms on
batch statistics (`bn_stats`, one pass or two); a random source `rng` adds
fairseq's train()-mode stochastics: input dropout, dropout after the
attention and the second FFN linear, and layerdrop (layer i runs iff its
uniform draw u_i > layerdrop; a dropped layer is skipped, which is
fairseq's behaviour and gives what the JAX package's select gives). The
source is a threefry key (`utils/prng.py`), split as the JAX package
splits it (`:110-225`: the input dropout's key, then `k_in, k_layers =
split(rng)`, the layer keys `split(k_layers, L)`, layerdrop's draws
`uniform(fold_in(rng, 7), (L,))`, and in each layer `k_attn, k_d1, k_d2,
k_d3 = split(key, 4)`), which draws the JAX package's masks bit for bit;
or a torch.Generator, from which one host draw takes layerdrop's uniforms,
the flash seeds and one seed per layer for a generator of the layer's own.
Either way every layer's draws are fixed before it runs, so a layer under
a remat policy (`remat`, `models/llm.py::maybe_remat`, as the JAX package
scans its layers under `maybe_remat`, `:222-225`) replays them when its
forward runs again in the backward. Attention: on the card, at T >=
FLASH_MIN_T_TRAIN with head dim 64 or 128, the trainable flash kernels (B3
forward, B4 backward) with the lengths as `kv_lengths` and the attention
dropout inside the kernels under an int32 seed (with a key
`randint(k_attn, (), 0, 2**31 - 1)`, as the JAX package routes it on the
TPU, `:146-164`); otherwise, and on the CPU, the plain
`dot_product_attention` with a padding mask and its dropout drawn from
the layer's key or generator.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..config import AVHubertConfig
from ..ops.attention import FLASH_MIN_T_TRAIN, dot_product_attention, padding_mask_from_lengths
from ..ops.augment import is_key, subkeys
from ..ops.flash_attention_bwd import flash_attention_trainable
from ..ops.norms import layer_norm
from ..parallel.collectives import draw_rows, first_row
from ..utils import prng
from .common import Params, layer_slice, linear, tp_ffn
from .llm import maybe_remat
from .resnet3d import resnet3d_forward
from .whisper import conv1d_nwc

# a layer's random source: a threefry key, the seed of a torch.Generator of
# its own, or None (no dropout)
LayerRng = Union[torch.Tensor, int, None]


def _pos_conv(x: torch.Tensor, p: Params, cfg: AVHubertConfig) -> torch.Tensor:
    """Grouped conv positional encoding; the even kernel's SamePad trims the
    final step (`wav2vec2.py:826-840`)."""
    y = conv1d_nwc(x, p["w"], p["b"], 1, cfg.conv_pos // 2, groups=cfg.conv_pos_groups)
    return F.gelu(y[:, :-1])


def _dropout(rng, x: torch.Tensor, rate: float) -> torch.Tensor:
    """x * Bernoulli(1 - rate) / (1 - rate), the mask drawn from `rng` (a
    threefry key: `bernoulli(key, 1 - rate, x.shape)`, or a
    torch.Generator); the identity without one."""
    if rng is None or rate <= 0.0:
        return x
    if is_key(rng):
        keep = draw_rows(lambda sh: prng.bernoulli(rng, 1.0 - rate, sh, x.device), x.shape)
    else:
        keep = draw_rows(lambda sh: torch.rand(sh, generator=rng, device=rng.device),
                         x.shape).to(x.device) < 1.0 - rate
    return x * keep.to(x.dtype) / (1.0 - rate)


def _flash_path(q: torch.Tensor) -> bool:
    return q.is_cuda and q.shape[1] >= FLASH_MIN_T_TRAIN and q.shape[3] in (64, 128)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: Optional[torch.Tensor],
               cfg: AVHubertConfig, rng, seed: Optional[int]) -> torch.Tensor:
    rate = cfg.attention_dropout if rng is not None else 0.0
    if _flash_path(q):
        lens = lengths.to(torch.int32).contiguous() if lengths is not None else None
        if rate > 0.0 and seed is None:  # a key: the JAX package's seed draw
            seed = int(prng.randint(rng, (), 0, 2**31 - 1))
        return flash_attention_trainable(q, k, v, kv_lengths=lens, dropout_rate=rate,
                                         dropout_seed=seed if rate > 0.0 else None,
                                         dropout_row0=first_row())
    mask = None
    if lengths is not None:
        mask = padding_mask_from_lengths(lengths, k.shape[1])[:, None, None, :]
    return dot_product_attention(q, k, v, mask=mask, dropout_rate=rate, generator=rng)


def _encoder_layer(layer: Params, cfg: AVHubertConfig, x: torch.Tensor,
                   lengths: Optional[torch.Tensor] = None, rng: LayerRng = None,
                   seed: Optional[int] = None) -> torch.Tensor:
    """One pre-LN layer; `rng` is the layer's key (split in four, JAX's
    order) or its generator's seed, `seed` the flash dropout seed drawn
    with a generator."""
    B, T, D = x.shape
    H = cfg.encoder_heads
    hd = D // H
    if isinstance(rng, int):
        rng = torch.Generator(device=x.device).manual_seed(rng)
    k_attn, k_d1, k_d2, k_d3 = subkeys(rng, 4) if rng is not None else (None,) * 4
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
                     lengths, cfg, k_attn, seed)
    x = x + _dropout(k_d1, linear(out.reshape(B, T, D), attn["o"]), cfg.dropout)
    h = layer_norm(x, layer["final_norm"]["scale"], layer["final_norm"]["bias"])
    h = tp_ffn(h, layer["fc1"], layer["fc2"], "avhubert.ffn", F.gelu,
               lambda a: _dropout(k_d2, a, cfg.activation_dropout))
    return x + _dropout(k_d3, h, cfg.dropout)


def avhubert_extract_features(params: Params, cfg: AVHubertConfig, video: Optional[torch.Tensor],
                              audio: Optional[torch.Tensor] = None, train_mode: bool = False,
                              conv_kernel: bool = False, bn_stats: str = "onepass") -> torch.Tensor:
    """Modality features and their fuse (`hubert.py:695-728`): the video
    (B, T, 88, 88, 1) through the ResNet trunk and `video_proj`, the stacked
    filterbanks (B, T, audio_feat_dim) through `audio_proj`; a missing
    modality is zero-filled (and `video=None` runs no trunk), the concat
    fuse puts audio first. `conv_kernel` runs the trunk's convs through
    B7, `bn_stats` is its train-mode BN variance."""
    if video is None and audio is None:
        raise ValueError("avhubert_extract_features needs video or audio")
    vfeat = afeat = None
    if video is not None:
        vf = resnet3d_forward(params["video_frontend"], video, train_mode, conv_kernel, bn_stats)
        vfeat = linear(vf, params["video_proj"])
    if audio is not None:
        afeat = linear(audio, params["audio_proj"])
    if vfeat is None:
        vfeat = torch.zeros_like(afeat)
    if afeat is None:
        afeat = torch.zeros_like(vfeat)
    if cfg.modality_fuse == "concat":
        feats = torch.cat([afeat, vfeat], dim=-1)  # audio first (`hubert.py:714`)
    else:
        feats = afeat + vfeat
    fn = params["fuse_norm"]
    feats = layer_norm(feats, fn["scale"], fn["bias"])
    return linear(feats, params["post_extract_proj"])


def _input_split(cfg: AVHubertConfig, key: torch.Tensor):
    """`avhubert_encode`'s split of a key (`:283-291`): (the input
    dropout's key or None, the encoder's key)."""
    if cfg.dropout_input > 0.0:
        return tuple(prng.split(key))
    return None, key


Plan = Tuple[List[int], List[LayerRng], List[Optional[int]]]


def _depth(cfg: AVHubertConfig, output_layer: Optional[int]) -> int:
    """The layers that run: all, or the first `output_layer` (1-based)."""
    if output_layer is None:
        return cfg.encoder_layers
    if not 1 <= output_layer <= cfg.encoder_layers:
        raise ValueError(f"output_layer {output_layer}: 1..{cfg.encoder_layers}")
    return output_layer


def _encoder_plan(cfg: AVHubertConfig, rng, L: int) -> Plan:
    """`layers_to_run` from the encoder's own random source, over L layers.
    A key draws as `avhubert_encoder` (`:210-216`): the layer keys
    `split(k_layers, L)` after `k_in, k_layers = split(rng)`, layerdrop's
    `uniform(fold_in(rng, 7), (L,))`."""
    if rng is None:
        return list(range(L)), [None] * L, [None] * L
    if is_key(rng):
        _, k_layers = prng.split(rng)
        keep = list(range(L))
        if cfg.layerdrop > 0.0:
            u = prng.uniform(prng.fold_in(rng, 7), (L,)).tolist()
            keep = [i for i in keep if u[i] > cfg.layerdrop]
        return keep, list(prng.split(k_layers, L)), [None] * L
    draws = torch.randint(0, 2**31 - 1, (3, L), generator=rng, device=rng.device).tolist()
    keep = [i for i in range(L) if draws[0][i] / 2**31 > cfg.layerdrop]
    return keep, draws[2], draws[1]


def layers_to_run(cfg: AVHubertConfig, rng, output_layer: Optional[int] = None) -> Plan:
    """(indices of the encoder layers to run, each layer's random source,
    each layer's flash dropout seed), for `avhubert_encode`'s random source
    and depth (`output_layer`). Without `rng`: every layer, no draws. With
    a key: layerdrop's uniforms and the layer keys, on the host (no sync),
    from the encoder's key after the input dropout's split; the seeds come
    from each layer's key in the layer. With a generator: one draw of (3, L)
    int32s (one host sync): layerdrop's uniforms, the flash seeds, and each
    layer's generator seed."""
    L = _depth(cfg, output_layer)
    if is_key(rng):
        rng = _input_split(cfg, rng)[1]
    return _encoder_plan(cfg, rng, L)


def avhubert_encoder(params: Params, cfg: AVHubertConfig, features: torch.Tensor,
                     lengths: Optional[torch.Tensor] = None, rng=None,
                     output_layer: Optional[int] = None, plan: Optional[Plan] = None,
                     remat: str = "off") -> torch.Tensor:
    """The transformer over fused (B, T, D) features (`:175-232`):
    pos-conv, the pre-LN layers, the top norm. `rng` (a key or a
    generator) enables train()-mode dropout and layerdrop; `plan` is
    `_encoder_plan`'s, drawn here when not given. `output_layer` (1-based)
    stops after that layer and skips the top norm: the layer-N feature dump
    behind iterative k-means targets (`clustering/dump_hubert_feature.py:
    96-106`; the top norm applies only when no layer is named)."""
    L = _depth(cfg, output_layer)
    keep, layer_rngs, seeds = plan if plan is not None else _encoder_plan(cfg, rng, L)
    k_in = prng.split(rng)[0] if is_key(rng) else rng
    x = features + _pos_conv(features, params["pos_conv"], cfg)
    x = _dropout(k_in, x, cfg.dropout)
    for i in keep:
        x = maybe_remat(_encoder_layer, remat, layer_slice(params["layers"], i), cfg, x, lengths,
                        layer_rngs[i], seeds[i])
    if output_layer is not None:
        return x
    tn = params["top_norm"]
    return layer_norm(x, tn["scale"], tn["bias"])


def avhubert_encode(params: Params, cfg: AVHubertConfig, video: Optional[torch.Tensor],
                    audio: Optional[torch.Tensor] = None, lengths: Optional[torch.Tensor] = None,
                    train_mode: bool = False, generator=None, plan: Optional[Plan] = None,
                    output_layer: Optional[int] = None, conv_kernel: bool = False,
                    bn_stats: str = "onepass", remat: str = "off") -> torch.Tensor:
    """`extract_finetune`: (B, T, D) from video and/or stacked-fbank audio;
    `lengths` (B,) masks each clip's padded frames as keys. `generator` is
    the random source (a threefry key or a torch.Generator; none in eval);
    `plan` is `layers_to_run`'s, drawn here when not given. `output_layer`
    N returns layer N's output without the top norm, 0 the fused features
    (ret_conv). `conv_kernel` runs the ResNet trunk's convs through B7,
    `bn_stats` is its train-mode BN variance, `remat` the encoder layers'
    remat policy."""
    assert cfg.layer_norm_first, "the post-LN variant is not ported"
    rng = generator
    if output_layer != 0 and plan is None:
        plan = layers_to_run(cfg, rng, output_layer)
    feats = avhubert_extract_features(params, cfg, video, audio, train_mode, conv_kernel,
                                      bn_stats)
    if output_layer == 0:  # ret_conv: the fused post-projection features
        return feats
    k_input, rng = _input_split(cfg, rng) if is_key(rng) else (rng, rng)
    feats = _dropout(k_input, feats, cfg.dropout_input)
    return avhubert_encoder(params, cfg, feats, lengths, rng, output_layer, plan, remat)
