"""fairseq AV-HuBERT checkpoint -> the port's AV-HuBERT parameters (port of
`omni_avsr_tpu/convert/avhubert_torch.py`).

Reads the `model` state dict of `large_vox_iter5.pt`-style checkpoints
(`av_hubert/avhubert/hubert.py:318-427`, `resnet.py:135-169`, fairseq
`wav2vec2.py:817-1040`) and the LoRA keys a trained Omni checkpoint adds
under `self_attn.lora_{down,up}_{Q,V}` (`modeling_OmniAVSR.py:127-142`).
A base checkpoint without them gets fresh adapters: zero downs and
uniform ups from a fixed numpy seed, the JAX package's values.

The positional conv's weight norm (g, v) folds into a plain conv weight
(torch weight_norm with dim=2: one norm over (out, in/groups) per kernel
position), in f64 as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..config import AVHubertConfig
from ..models.common import Params
from .common import (
    batch_norm_from_torch,
    layer_norm_from_torch,
    linear_from_torch,
    stack_dicts,
    t2n,
    to_torch,
)


def _conv2d_nobias(sd: Mapping[str, Any], key: str) -> Dict[str, np.ndarray]:
    return {"w": t2n(sd[key]).transpose(2, 3, 1, 0)}


def _prelu(sd: Mapping[str, Any], key: str) -> Optional[np.ndarray]:
    return t2n(sd[key]) if key in sd else None


def _basic_block(sd: Mapping[str, Any], p: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "conv1": _conv2d_nobias(sd, f"{p}.conv1.weight"),
        "bn1": batch_norm_from_torch(sd, f"{p}.bn1"),
        "conv2": _conv2d_nobias(sd, f"{p}.conv2.weight"),
        "bn2": batch_norm_from_torch(sd, f"{p}.bn2"),
    }
    for i in (1, 2):
        a = _prelu(sd, f"{p}.relu{i}.weight")
        if a is not None:
            out[f"prelu{i}"] = a
    if f"{p}.downsample.0.weight" in sd:
        out["downsample"] = {"conv": _conv2d_nobias(sd, f"{p}.downsample.0.weight"),
                             "bn": batch_norm_from_torch(sd, f"{p}.downsample.1")}
    return out


def _resnet(sd: Mapping[str, Any], root: str) -> Dict[str, Any]:
    stem: Dict[str, Any] = {
        "conv": {"w": t2n(sd[f"{root}.frontend3D.0.weight"]).transpose(2, 3, 4, 1, 0)},
        "bn": batch_norm_from_torch(sd, f"{root}.frontend3D.1"),
    }
    a = _prelu(sd, f"{root}.frontend3D.2.weight")
    if a is not None:
        stem["prelu"] = a
    out: Dict[str, Any] = {"stem": stem}
    for li in range(1, 5):
        out[f"layer{li}"] = {"b0": _basic_block(sd, f"{root}.trunk.layer{li}.0"),
                             "b1": _basic_block(sd, f"{root}.trunk.layer{li}.1")}
    return out


def fold_weight_norm_conv1d(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    """w = g * v / ||v|| for a Conv1d weight (O, I/groups, K) under
    weight_norm(dim=2): the norm over (O, I/groups) per kernel position."""
    norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=(0, 1), keepdims=True))
    return (g * v / norm).astype(np.float32)


def _fresh_lora(D: int, r: int) -> Dict[str, Any]:
    rng = np.random.RandomState(0)
    bound = np.sqrt(1.0 / r)
    return {"down_q": {"w": np.zeros((D, r), np.float32)},
            "up_q": {"w": rng.uniform(-bound, bound, (r, D)).astype(np.float32)},
            "down_v": {"w": np.zeros((D, r), np.float32)},
            "up_v": {"w": rng.uniform(-bound, bound, (r, D)).astype(np.float32)}}


def convert_avhubert(sd: Mapping[str, Any], cfg: AVHubertConfig,
                     dtype: torch.dtype = torch.bfloat16,
                     lora_dtype: torch.dtype = torch.float32) -> Params:
    """The frozen encoder in `dtype`; the LoRA adapters, which train, in
    `lora_dtype` straight from the f32 values (no round trip through
    `dtype`)."""
    D = cfg.encoder_embed_dim
    layers = []
    for i in range(cfg.encoder_layers):
        p = f"encoder.layers.{i}"
        layer: Dict[str, Any] = {
            "attn_norm": layer_norm_from_torch(sd, f"{p}.self_attn_layer_norm"),
            "attn": {
                "q": linear_from_torch(sd, f"{p}.self_attn.q_proj"),
                "k": linear_from_torch(sd, f"{p}.self_attn.k_proj"),
                "v": linear_from_torch(sd, f"{p}.self_attn.v_proj"),
                "o": linear_from_torch(sd, f"{p}.self_attn.out_proj"),
            },
            "final_norm": layer_norm_from_torch(sd, f"{p}.final_layer_norm"),
            "fc1": linear_from_torch(sd, f"{p}.fc1"),
            "fc2": linear_from_torch(sd, f"{p}.fc2"),
        }
        if cfg.lora_rank_divisor:
            a = f"{p}.self_attn"
            if f"{a}.lora_down_Q.weight" in sd:
                layer["lora"] = {
                    "down_q": linear_from_torch(sd, f"{a}.lora_down_Q", bias=False),
                    "up_q": linear_from_torch(sd, f"{a}.lora_up_Q", bias=False),
                    "down_v": linear_from_torch(sd, f"{a}.lora_down_V", bias=False),
                    "up_v": linear_from_torch(sd, f"{a}.lora_up_V", bias=False),
                }
            else:
                layer["lora"] = _fresh_lora(D, round(D / cfg.lora_rank_divisor))
        layers.append(layer)

    pos_w = fold_weight_norm_conv1d(t2n(sd["encoder.pos_conv.0.weight_g"]),
                                    t2n(sd["encoder.pos_conv.0.weight_v"]))  # (O, I/g, K)
    params: Dict[str, Any] = {
        "video_frontend": _resnet(sd, "feature_extractor_video.resnet"),
        "video_proj": linear_from_torch(sd, "feature_extractor_video.proj"),
        "audio_proj": linear_from_torch(sd, "feature_extractor_audio.proj"),
        "fuse_norm": layer_norm_from_torch(sd, "layer_norm"),
        "post_extract_proj": linear_from_torch(sd, "post_extract_proj"),
        "pos_conv": {"w": pos_w.transpose(2, 1, 0), "b": t2n(sd["encoder.pos_conv.0.bias"])},
        "layers": stack_dicts(layers),
        "top_norm": layer_norm_from_torch(sd, "encoder.layer_norm"),
    }
    lora = params["layers"].pop("lora", None)
    out = to_torch(params, dtype)
    if lora is not None:
        out["layers"]["lora"] = to_torch(lora, lora_dtype)
    return out
