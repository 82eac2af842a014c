"""Trained Omni-AVSR / Llama-AVSR checkpoint -> the port's full parameter
tree (port of `omni_avsr_tpu/convert/omni_ckpt.py`).

The reference saves the whole `AVSR_LLMs` state dict (lightning strips the
`model.` prefix at eval load, `lightning_OmniAVSR.py:148-150`). Subtrees:

  audio_encoder.*       HF Whisper encoder           -> params["whisper"]
  video_encoder.*       fairseq AV-HuBERT (+ LoRA)   -> params["avhubert"]
  audio_proj.* /
  video_proj.*          Sequential / ModuleList MLPs -> projector bundles
  llm.*                 Llama/Qwen ForCausalLM_lora  -> params["llm"]
  prompt_* buffers      recomputed from the tokenizer (skipped)

A projector has its LayerNorm where the checkpoint has the key (index 3 of
the Sequential), which follows the reference's inconsistent LN choices
(`modeling_OmniAVSR.py:104, 162, 188`) without a table.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import torch

from ..config import OmniConfig
from ..models.common import Params
from .avhubert_torch import convert_avhubert
from .common import layer_norm_from_torch, linear_from_torch, to_torch
from .llm_torch import convert_llm
from .whisper_torch import convert_whisper_encoder


def _sub(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _one_projector(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    p: Dict[str, Any] = {"fc1": linear_from_torch(sd, f"{prefix}.0"),
                         "fc2": linear_from_torch(sd, f"{prefix}.2")}
    if f"{prefix}.3.weight" in sd:
        p["ln"] = layer_norm_from_torch(sd, f"{prefix}.3")
    return p


def convert_projectors(sd: Mapping[str, Any], name: str, rates: Sequence[int],
                       dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """`name` is "audio_proj" or "video_proj": one Sequential ({"single"})
    or a ModuleList with one per rate ({"per_rate": {"r<rate>": ...}})."""
    if f"{name}.0.weight" in sd:
        tree = {"single": _one_projector(sd, name)}
    else:
        tree = {"per_rate": {f"r{rate}": _one_projector(sd, f"{name}.{i}")
                             for i, rate in enumerate(rates)}}
    return to_torch(tree, dtype)


def convert_omni_checkpoint(sd: Mapping[str, Any], cfg: OmniConfig,
                            frozen_dtype: torch.dtype = torch.bfloat16,
                            train_dtype: torch.dtype = torch.float32) -> Params:
    """The frozen towers and LLM in `frozen_dtype`; the projectors and the
    LoRA adapters, which train, in `train_dtype` (LoRA always f32, as in
    the JAX package)."""
    if any(k.startswith("model.") and not k.startswith("model.layers") for k in sd):
        if not any(k.startswith("llm.") for k in sd):
            sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    params: Params = {}
    if any(k.startswith("llm.") for k in sd):
        params["llm"] = convert_llm(_sub(sd, "llm."), cfg.llm, dtype=frozen_dtype)
    if any(k.startswith("audio_encoder.") for k in sd):
        params["whisper"] = convert_whisper_encoder(_sub(sd, "audio_encoder."), cfg.whisper,
                                                    dtype=frozen_dtype)
        params["audio_proj"] = convert_projectors(sd, "audio_proj", cfg.audio_rates, train_dtype)
    if any(k.startswith("video_encoder.") for k in sd):
        params["avhubert"] = convert_avhubert(_sub(sd, "video_encoder."), cfg.avhubert,
                                              dtype=frozen_dtype)
        params["video_proj"] = convert_projectors(sd, "video_proj", cfg.video_rates, train_dtype)
    return params


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """A reference .pth/.ckpt loaded on the CPU as a flat state dict (the
    `state_dict` of a lightning checkpoint, the `model` of a fairseq one).
    The file is unpickled: load only checkpoints from a trusted source."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
        obj = obj["model"]
    return obj
