"""HF `WhisperModel.encoder` state dict -> the port's Whisper parameters
(port of `omni_avsr_tpu/convert/whisper_torch.py`).

Keys follow HF `modeling_whisper.WhisperEncoder` (the module the reference
freezes, `modeling_OmniAVSR.py:59-62`) and start at the encoder root:
strip `model.encoder.` upstream when converting a whole `WhisperModel`.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from ..config import WhisperEncoderConfig
from ..models.common import Params
from .common import conv1d_from_torch, layer_norm_from_torch, linear_from_torch, stack_dicts, t2n, to_torch


def convert_whisper_encoder(sd: Mapping[str, Any], cfg: WhisperEncoderConfig,
                            dtype: torch.dtype = torch.bfloat16) -> Params:
    layers = []
    for i in range(cfg.num_layers):
        p = f"layers.{i}"
        layers.append({
            "attn_norm": layer_norm_from_torch(sd, f"{p}.self_attn_layer_norm"),
            "attn": {
                "q": linear_from_torch(sd, f"{p}.self_attn.q_proj"),
                "k": linear_from_torch(sd, f"{p}.self_attn.k_proj", bias=False),
                "v": linear_from_torch(sd, f"{p}.self_attn.v_proj"),
                "o": linear_from_torch(sd, f"{p}.self_attn.out_proj"),
            },
            "mlp_norm": layer_norm_from_torch(sd, f"{p}.final_layer_norm"),
            "fc1": linear_from_torch(sd, f"{p}.fc1"),
            "fc2": linear_from_torch(sd, f"{p}.fc2"),
        })
    return to_torch({
        "conv1": conv1d_from_torch(sd, "conv1"),
        "conv2": conv1d_from_torch(sd, "conv2"),
        "pos_embed": t2n(sd["embed_positions.weight"]),
        "layers": stack_dicts(layers),
        "final_norm": layer_norm_from_torch(sd, "layer_norm"),
    }, dtype)
