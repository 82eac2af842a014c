"""Parameter trees in and out of the port.

`params_from_numpy` carries a JAX parameter tree across (handed over as
numpy arrays, e.g. from `jax.device_get`), leaf for leaf, into torch
tensors: int8 codes, packed-int4 bytes ({"w4": int8 or uint8}) and f32
scales stay bit-identical, and floating leaves can be cast to one dtype.

`split_trainable` turns such a tree into the port's training pair: f32
trainable leaves and frozen leaves in one dtype (`train/state.py`), so
that one JAX-initialised tree trains the same in both packages.

`init_params` builds the same tree shapes directly on the device with a
`torch.Generator`, in the distributions of the JAX package's initialisers
(not the same numbers), for runs that need no JAX and no host-side copy
of the weights.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import MODALITIES, AVHubertConfig, LLMConfig, OmniConfig, WhisperEncoderConfig
from .models.common import Params
from .models.whisper import sinusoidal_positions


def _to_tensor(a: Any, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: Dict[str, Any], device="cuda", dtype: Optional[torch.dtype] = None) -> Params:
    """Nested dict of numpy arrays -> the same nested dict of tensors."""
    return {k: (params_from_numpy(v, device, dtype) if isinstance(v, dict)
                else _to_tensor(v, device, dtype))
            for k, v in tree.items()}


def split_trainable(tree: Dict[str, Any], predicate: Callable[[str], bool], device="cuda",
                    frozen_dtype: Optional[torch.dtype] = torch.bfloat16
                    ) -> Tuple[Optional[Params], Optional[Params]]:
    """numpy tree -> (trainable leaves in f32, frozen leaves in
    `frozen_dtype`) on `device`, split by the dotted-path `predicate`
    (`OmniAVSR.trainable_predicate`)."""
    from .train.state import split_params

    trainable, frozen = split_params(tree, predicate)
    return (params_from_numpy(trainable, device, torch.float32) if trainable else None,
            params_from_numpy(frozen, device, frozen_dtype) if frozen else None)


class _Init:
    """Random leaves on one device from one generator."""

    def __init__(self, generator: torch.Generator, device, dtype):
        self.g, self.device, self.dtype = generator, device, dtype

    def uniform(self, shape: Sequence[int], bound: float) -> torch.Tensor:
        t = torch.empty(tuple(shape), device=self.device, dtype=torch.float32)
        t.uniform_(-bound, bound, generator=self.g)
        return t.to(self.dtype)

    def normal(self, shape: Sequence[int], std: float) -> torch.Tensor:
        t = torch.empty(tuple(shape), device=self.device, dtype=torch.float32)
        t.normal_(0.0, std, generator=self.g)
        return t.to(self.dtype)

    def const(self, shape: Sequence[int], value: float) -> torch.Tensor:
        return torch.full(tuple(shape), value, device=self.device, dtype=self.dtype)

    def linear(self, lead: Sequence[int], i: int, o: int, bias: bool = True) -> Params:
        """torch nn.Linear init: U(+-1/sqrt(in)) on weight and bias."""
        bound = math.sqrt(1.0 / i)
        p = {"w": self.uniform((*lead, i, o), bound)}
        if bias:
            p["b"] = self.uniform((*lead, o), bound)
        return p

    def layer_norm(self, lead: Sequence[int], d: int) -> Params:
        return {"scale": self.const((*lead, d), 1.0), "bias": self.const((*lead, d), 0.0)}


def _init_llm(ini: _Init, cfg: LLMConfig) -> Params:
    L, h = (cfg.num_layers,), cfg.hidden_size
    bias = cfg.attention_bias
    layers: Params = {
        "input_norm": {"scale": ini.const((*L, h), 1.0)},
        "post_attn_norm": {"scale": ini.const((*L, h), 1.0)},
        "attn": {
            "q": ini.linear(L, h, cfg.q_dim, bias),
            "k": ini.linear(L, h, cfg.kv_dim, bias),
            "v": ini.linear(L, h, cfg.kv_dim, bias),
            "o": ini.linear(L, cfg.q_dim, h, False),
        },
        "mlp": {
            "gate": ini.linear(L, h, cfg.intermediate_size, False),
            "up": ini.linear(L, h, cfg.intermediate_size, False),
            "down": ini.linear(L, cfg.intermediate_size, h, False),
        },
    }
    if cfg.lora is not None:
        r = cfg.lora.bottleneck(h)
        v_out = h // cfg.lora.v_out_divisor

        def pair():  # zero down, kaiming-uniform up (`Llama_LoRA.py:189-192`)
            return {
                "down_q": {"w": ini.const((*L, h, r), 0.0)},
                "up_q": ini.linear(L, r, h, False),
                "down_v": {"w": ini.const((*L, h, r), 0.0)},
                "up_v": ini.linear(L, r, v_out, False),
            }

        layers["lora"] = {m: pair() for m in MODALITIES} if cfg.lora.task_specific else pair()
    params: Params = {
        "embed": {"w": ini.normal((cfg.vocab_size, h), 0.02)},
        "layers": layers,
        "final_norm": {"scale": ini.const((h,), 1.0)},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"w": ini.normal((h, cfg.vocab_size), 0.02)}
    return params


def _init_whisper(ini: _Init, cfg: WhisperEncoderConfig) -> Params:
    L, D = (cfg.num_layers,), cfg.hidden_size
    return {
        "conv1": {"w": ini.uniform((3, cfg.num_mel_bins, D), math.sqrt(1.0 / (cfg.num_mel_bins * 3))),
                  "b": ini.const((D,), 0.0)},
        "conv2": {"w": ini.uniform((3, D, D), math.sqrt(1.0 / (D * 3))),
                  "b": ini.const((D,), 0.0)},
        "pos_embed": torch.from_numpy(sinusoidal_positions(cfg.max_source_positions, D)).to(
            device=ini.device, dtype=ini.dtype),
        "layers": {
            "attn_norm": ini.layer_norm(L, D),
            "attn": {"q": ini.linear(L, D, D), "k": ini.linear(L, D, D, False),
                     "v": ini.linear(L, D, D), "o": ini.linear(L, D, D)},
            "mlp_norm": ini.layer_norm(L, D),
            "fc1": ini.linear(L, D, cfg.ffn_dim),
            "fc2": ini.linear(L, cfg.ffn_dim, D),
        },
        "final_norm": ini.layer_norm((), D),
    }


def _init_resnet3d(ini: _Init, relu_type: str) -> Params:
    def conv(kh, kw, cin, cout):
        return {"w": ini.normal((kh, kw, cin, cout), math.sqrt(2.0 / (kh * kw * cout)))}

    def bn(c):
        return {"scale": ini.const((c,), 1.0), "bias": ini.const((c,), 0.0),
                "mean": ini.const((c,), 0.0), "var": ini.const((c,), 1.0)}

    def block(cin, cout, downsample):
        p = {"conv1": conv(3, 3, cin, cout), "bn1": bn(cout),
             "conv2": conv(3, 3, cout, cout), "bn2": bn(cout)}
        if relu_type == "prelu":
            p["prelu1"] = ini.const((cout,), 0.25)
            p["prelu2"] = ini.const((cout,), 0.25)
        if downsample:
            p["downsample"] = {"conv": conv(1, 1, cin, cout), "bn": bn(cout)}
        return p

    params: Params = {
        "stem": {"conv": {"w": ini.normal((5, 7, 7, 1, 64), math.sqrt(2.0 / (5 * 7 * 7 * 64)))},
                 "bn": bn(64)},
        "layer1": {"b0": block(64, 64, False), "b1": block(64, 64, False)},
        "layer2": {"b0": block(64, 128, True), "b1": block(128, 128, False)},
        "layer3": {"b0": block(128, 256, True), "b1": block(256, 256, False)},
        "layer4": {"b0": block(256, 512, True), "b1": block(512, 512, False)},
    }
    if relu_type == "prelu":
        params["stem"]["prelu"] = ini.const((64,), 0.25)
    return params


def _init_avhubert(ini: _Init, cfg: AVHubertConfig) -> Params:
    L, D = (cfg.encoder_layers,), cfg.encoder_embed_dim
    layers: Params = {
        "attn_norm": ini.layer_norm(L, D),
        "attn": {n: ini.linear(L, D, D) for n in ("q", "k", "v", "o")},
        "final_norm": ini.layer_norm(L, D),
        "fc1": ini.linear(L, D, cfg.encoder_ffn_dim),
        "fc2": ini.linear(L, cfg.encoder_ffn_dim, D),
    }
    if cfg.lora_rank_divisor:
        r = round(D / cfg.lora_rank_divisor)
        layers["lora"] = {"down_q": {"w": ini.const((*L, D, r), 0.0)}, "up_q": ini.linear(L, r, D, False),
                          "down_v": {"w": ini.const((*L, D, r), 0.0)}, "up_v": ini.linear(L, r, D, False)}
    fuse = 2 * D if cfg.modality_fuse == "concat" else D
    return {
        "video_frontend": _init_resnet3d(ini, cfg.resnet_relu_type),
        "video_proj": ini.linear((), 512, D),
        "audio_proj": ini.linear((), cfg.audio_feat_dim, D),
        "fuse_norm": ini.layer_norm((), fuse),
        "post_extract_proj": ini.linear((), fuse, D),
        "pos_conv": {"w": ini.normal((cfg.conv_pos, D // cfg.conv_pos_groups, D),
                                     (4.0 / (cfg.conv_pos * D)) ** 0.5),
                     "b": ini.const((D,), 0.0)},
        "layers": layers,
        "top_norm": ini.layer_norm((), D),
    }


def _init_projectors(ini: _Init, cfg: OmniConfig, rates, enc_dim: int) -> Params:
    """One modality's projectors, by the decision table of the JAX
    package's `init_matry_projectors` (`omni_avsr_tpu/models/projector.py:55-101`):
    one projector without matryoshka or with `is_single_matry_projector`,
    with its LayerNorm unless `remove_layernorm_from_projector` (its input
    is enc_dim x the single rate for non-matryoshka stacking); else one per
    rate, never with a LayerNorm (the reference's LN-as-bias quirk), whose
    input is enc_dim x rate when stacking."""
    inter, out = cfg.projector_intermediate_size, cfg.llm.hidden_size
    stack = cfg.compression_mode == "stack"

    def projector(in_dim: int, with_ln: bool) -> Params:
        p = {"fc1": ini.linear((), in_dim, inter), "fc2": ini.linear((), inter, out)}
        if with_ln:
            p["ln"] = ini.layer_norm((), out)
        return p

    if not cfg.is_matryoshka or cfg.is_single_matry_projector:
        dim = enc_dim * rates[0] if stack and not cfg.is_matryoshka else enc_dim
        return {"single": projector(dim, not cfg.remove_layernorm_from_projector)}
    return {"per_rate": {f"r{r}": projector(enc_dim * r if stack else enc_dim, False)
                         for r in rates}}


def init_params(cfg: OmniConfig, generator: torch.Generator, device="cuda",
                frozen_dtype=torch.bfloat16, train_dtype=torch.float32) -> Params:
    """The OmniAVSR tree (`models/omni.py::OmniAVSR.init_params` of the JAX
    package) built on `device`: frozen towers and LLM in `frozen_dtype`,
    projectors in `train_dtype`."""
    frozen = _Init(generator, device, frozen_dtype)
    train = _Init(generator, device, train_dtype)
    params: Params = {"llm": _init_llm(frozen, cfg.llm)}
    if cfg.modality in ("audio", "audiovisual") and cfg.whisper is not None:
        params["whisper"] = _init_whisper(frozen, cfg.whisper)
        params["audio_proj"] = _init_projectors(train, cfg, cfg.audio_rates, cfg.whisper.hidden_size)
    if cfg.modality in ("video", "audiovisual") and cfg.avhubert is not None:
        params["avhubert"] = _init_avhubert(frozen, cfg.avhubert)
        params["video_proj"] = _init_projectors(train, cfg, cfg.video_rates,
                                                cfg.avhubert.encoder_embed_dim)
    return params
