"""HF Llama / Qwen2 state dict -> the port's LLM parameters (port of
`omni_avsr_tpu/convert/llm_torch.py`).

Covers base HF checkpoints (`model.layers.N...`, `model.embed_tokens.weight`,
`lm_head.weight` when untied; Qwen's q/k/v biases) and the reference's LoRA
keys (`Llama_LoRA.py`, `Qwen_LoRA.py`):
`model.layers.N.self_attn.lora_{down,up}_{Q,V}[.<modality>].weight` and the
`_shared` variants, per-modality adapters mapping to {"lora": {modality: ...}}.
Missing adapters are made fresh (zero downs, uniform ups from a fixed numpy
seed per layer), the JAX package's values. A trained Omni checkpoint goes
through `convert/omni_ckpt.py`, which hands its `llm.` subtree here.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..config import MODALITIES, LLMConfig
from ..models.common import Params
from .common import linear_from_torch, rms_norm_from_torch, stack_dicts, t2n, to_torch


def _lora_adapter(sd: Mapping[str, Any], attn: str, suffix: str = "") -> Dict[str, Any]:
    return {
        "down_q": linear_from_torch(sd, f"{attn}.lora_down_Q{suffix}", bias=False),
        "up_q": linear_from_torch(sd, f"{attn}.lora_up_Q{suffix}", bias=False),
        "down_v": linear_from_torch(sd, f"{attn}.lora_down_V{suffix}", bias=False),
        "up_v": linear_from_torch(sd, f"{attn}.lora_up_V{suffix}", bias=False),
    }


def _fresh_lora(cfg: LLMConfig, seed: int) -> Dict[str, Any]:
    rng = np.random.RandomState(seed)
    h = cfg.hidden_size
    r = cfg.lora.bottleneck(h)
    bound = np.sqrt(1.0 / r)
    return {
        "down_q": {"w": np.zeros((h, r), np.float32)},
        "up_q": {"w": rng.uniform(-bound, bound, (r, h)).astype(np.float32)},
        "down_v": {"w": np.zeros((h, r), np.float32)},
        "up_v": {"w": rng.uniform(-bound, bound, (r, h // cfg.lora.v_out_divisor))
                 .astype(np.float32)},
    }


def convert_llm(sd: Mapping[str, Any], cfg: LLMConfig, dtype: torch.dtype = torch.bfloat16,
                lora_dtype: torch.dtype = torch.float32) -> Params:
    """An HF (or LoRA-extended) causal-LM state dict, with or without the
    `model.` prefix: the frozen weights in `dtype`, the LoRA adapters in
    `lora_dtype` straight from the f32 values."""
    if not any(k.startswith("model.") for k in sd):
        sd = {f"model.{k}" if not k.startswith("lm_head") else k: v for k, v in sd.items()}
    bias = cfg.attention_bias
    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        attn = f"{p}.self_attn"
        layer: Dict[str, Any] = {
            "input_norm": rms_norm_from_torch(sd, f"{p}.input_layernorm"),
            "post_attn_norm": rms_norm_from_torch(sd, f"{p}.post_attention_layernorm"),
            "attn": {
                "q": linear_from_torch(sd, f"{attn}.q_proj", bias=bias),
                "k": linear_from_torch(sd, f"{attn}.k_proj", bias=bias),
                "v": linear_from_torch(sd, f"{attn}.v_proj", bias=bias),
                "o": linear_from_torch(sd, f"{attn}.o_proj", bias=False),
            },
            "mlp": {
                "gate": linear_from_torch(sd, f"{p}.mlp.gate_proj", bias=False),
                "up": linear_from_torch(sd, f"{p}.mlp.up_proj", bias=False),
                "down": linear_from_torch(sd, f"{p}.mlp.down_proj", bias=False),
            },
        }
        if cfg.lora is not None:
            if cfg.lora.task_specific:
                if f"{attn}.lora_down_Q.audio.weight" in sd:
                    layer["lora"] = {m: _lora_adapter(sd, attn, f".{m}") for m in MODALITIES}
                else:
                    layer["lora"] = {m: _fresh_lora(cfg, seed=i * 4 + j)
                                     for j, m in enumerate(MODALITIES)}
                if cfg.lora.shared:
                    layer["lora_shared"] = (_lora_adapter(sd, attn, "_shared")
                                            if f"{attn}.lora_down_Q_shared.weight" in sd
                                            else _fresh_lora(cfg, seed=10000 + i))
            else:
                layer["lora"] = (_lora_adapter(sd, attn) if f"{attn}.lora_down_Q.weight" in sd
                                 else _fresh_lora(cfg, seed=i))
        layers.append(layer)

    params: Dict[str, Any] = {
        "embed": {"w": t2n(sd["model.embed_tokens.weight"])},
        "layers": stack_dicts(layers),
        "final_norm": rms_norm_from_torch(sd, "model.norm"),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"w": t2n(sd["lm_head.weight"]).T}
    adapters = {k: params["layers"].pop(k) for k in ("lora", "lora_shared")
                if k in params["layers"]}
    out = to_torch(params, dtype)
    out["layers"].update(to_torch(adapters, lora_dtype))
    return out
