"""Fine-tuned AV-HuBERT seq2seq checkpoint -> the port's parameters (port of
`omni_avsr_tpu/convert/avhubert_s2s_torch.py`).

Layout of `av_hubert/avhubert/hubert_asr.py` (AVHubertSeq2Seq):
  encoder.w2v_model.*   the AV-HuBERT encoder (`convert_avhubert`)
  decoder.embed_tokens.weight / decoder.layers.N.{self_attn,encoder_attn,
  fc1,fc2,*_layer_norm}.* / decoder.embed_out (when untied)
The positional table is fairseq's sinusoids, computed, not read.
`avhubert_s2s_state_dict` is the inverse: a tree in that layout (numpy,
the positional conv as weight_g / weight_v), which the converter reads
back; it makes the synthetic checkpoints of random trees the smoke run
evaluates.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ..config import AVHubertConfig
from ..models.avhubert_s2s import S2SDecoderConfig, sinusoidal_embedding
from ..models.common import Params
from .avhubert_torch import convert_avhubert
from .common import layer_norm_from_torch, linear_from_torch, stack_dicts, t2n, to_torch


def _sub(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    plen = len(prefix)
    return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix)}


def convert_s2s_decoder(sd: Mapping[str, Any], cfg: S2SDecoderConfig,
                        dtype: torch.dtype = torch.float32) -> Params:
    """fairseq TransformerDecoder state dict (keys without `decoder.`) -> the
    decoder tree in `dtype`, on the CPU."""
    layers = []
    for i in range(cfg.layers):
        p = f"layers.{i}"
        layers.append({
            "self_attn": {
                "q": linear_from_torch(sd, f"{p}.self_attn.q_proj"),
                "k": linear_from_torch(sd, f"{p}.self_attn.k_proj"),
                "v": linear_from_torch(sd, f"{p}.self_attn.v_proj"),
                "o": linear_from_torch(sd, f"{p}.self_attn.out_proj"),
            },
            "self_norm": layer_norm_from_torch(sd, f"{p}.self_attn_layer_norm"),
            "cross_attn": {
                "q": linear_from_torch(sd, f"{p}.encoder_attn.q_proj"),
                "k": linear_from_torch(sd, f"{p}.encoder_attn.k_proj"),
                "v": linear_from_torch(sd, f"{p}.encoder_attn.v_proj"),
                "o": linear_from_torch(sd, f"{p}.encoder_attn.out_proj"),
            },
            "cross_norm": layer_norm_from_torch(sd, f"{p}.encoder_attn_layer_norm"),
            "fc1": linear_from_torch(sd, f"{p}.fc1"),
            "fc2": linear_from_torch(sd, f"{p}.fc2"),
            "final_norm": layer_norm_from_torch(sd, f"{p}.final_layer_norm"),
        })
    params: Dict[str, Any] = {
        "embed": {"w": t2n(sd["embed_tokens.weight"])},
        "pos": sinusoidal_embedding(cfg.max_target_positions + cfg.pad_id + 1, cfg.embed_dim,
                                    cfg.pad_id),
        "layers": stack_dicts(layers),
    }
    if "embed_out" in sd:
        params["embed_out"] = {"w": t2n(sd["embed_out"]).T}
    return to_torch(params, dtype)


def convert_avhubert_s2s(sd: Mapping[str, Any], enc_cfg: AVHubertConfig,
                         dec_cfg: S2SDecoderConfig,
                         dtype: torch.dtype = torch.bfloat16) -> Tuple[Params, Params]:
    """(encoder params, decoder params), both in `dtype`, on the CPU."""
    enc = convert_avhubert(_sub(sd, "encoder.w2v_model."), enc_cfg, dtype, lora_dtype=dtype)
    dec = convert_s2s_decoder(_sub(sd, "decoder."), dec_cfg, dtype)
    return enc, dec


def _np(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _unlinear(sd: Dict[str, np.ndarray], key: str, p: Params, i=None) -> None:
    w, b = _np(p["w"]), _np(p["b"]) if "b" in p else None
    if i is not None:
        w, b = w[i], None if b is None else b[i]
    sd[f"{key}.weight"] = np.ascontiguousarray(w.T)
    if b is not None:
        sd[f"{key}.bias"] = b


def _unnorm(sd: Dict[str, np.ndarray], key: str, p: Params, i=None, running=False) -> None:
    pick = (lambda x: _np(x)) if i is None else (lambda x: _np(x)[i])
    sd[f"{key}.weight"], sd[f"{key}.bias"] = pick(p["scale"]), pick(p["bias"])
    if running:
        sd[f"{key}.running_mean"], sd[f"{key}.running_var"] = pick(p["mean"]), pick(p["var"])


def _unresnet(sd: Dict[str, np.ndarray], root: str, tree: Params) -> None:
    stem = tree["stem"]
    sd[f"{root}.frontend3D.0.weight"] = _np(stem["conv"]["w"]).transpose(4, 3, 0, 1, 2)
    _unnorm(sd, f"{root}.frontend3D.1", stem["bn"], running=True)
    if "prelu" in stem:
        sd[f"{root}.frontend3D.2.weight"] = _np(stem["prelu"])
    for li in range(1, 5):
        for bi in range(2):
            p, blk = f"{root}.trunk.layer{li}.{bi}", tree[f"layer{li}"][f"b{bi}"]
            for c in (1, 2):
                sd[f"{p}.conv{c}.weight"] = _np(blk[f"conv{c}"]["w"]).transpose(3, 2, 0, 1)
                _unnorm(sd, f"{p}.bn{c}", blk[f"bn{c}"], running=True)
                if f"prelu{c}" in blk:
                    sd[f"{p}.relu{c}.weight"] = _np(blk[f"prelu{c}"])
            if "downsample" in blk:
                ds = blk["downsample"]
                sd[f"{p}.downsample.0.weight"] = _np(ds["conv"]["w"]).transpose(3, 2, 0, 1)
                _unnorm(sd, f"{p}.downsample.1", ds["bn"], running=True)


def avhubert_s2s_state_dict(enc: Params, dec: Params) -> Dict[str, np.ndarray]:
    """An encoder tree (without LoRA) and a decoder tree -> an AVHubertSeq2Seq
    state dict in fairseq's key layout (numpy f32), which
    `convert_avhubert_s2s` reads back."""
    sd: Dict[str, np.ndarray] = {}
    e = "encoder.w2v_model"
    _unresnet(sd, f"{e}.feature_extractor_video.resnet", enc["video_frontend"])
    _unlinear(sd, f"{e}.feature_extractor_video.proj", enc["video_proj"])
    _unlinear(sd, f"{e}.feature_extractor_audio.proj", enc["audio_proj"])
    _unnorm(sd, f"{e}.layer_norm", enc["fuse_norm"])
    _unlinear(sd, f"{e}.post_extract_proj", enc["post_extract_proj"])
    w = _np(enc["pos_conv"]["w"]).transpose(2, 1, 0)  # (O, I/groups, K)
    # weight norm over (O, I/groups) per kernel position: g = ||w||, v = w
    sd[f"{e}.encoder.pos_conv.0.weight_g"] = np.sqrt(
        np.sum(w.astype(np.float64) ** 2, axis=(0, 1), keepdims=True)).astype(np.float32)
    sd[f"{e}.encoder.pos_conv.0.weight_v"] = w
    sd[f"{e}.encoder.pos_conv.0.bias"] = _np(enc["pos_conv"]["b"])
    layers = enc["layers"]
    for i in range(_np(layers["fc1"]["w"]).shape[0]):
        p = f"{e}.encoder.layers.{i}"
        for k, public in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            _unlinear(sd, f"{p}.self_attn.{public}", layers["attn"][k], i)
        _unnorm(sd, f"{p}.self_attn_layer_norm", layers["attn_norm"], i)
        _unnorm(sd, f"{p}.final_layer_norm", layers["final_norm"], i)
        _unlinear(sd, f"{p}.fc1", layers["fc1"], i)
        _unlinear(sd, f"{p}.fc2", layers["fc2"], i)
    _unnorm(sd, f"{e}.encoder.layer_norm", enc["top_norm"])
    sd["decoder.embed_tokens.weight"] = _np(dec["embed"]["w"])
    if "embed_out" in dec:
        sd["decoder.embed_out"] = np.ascontiguousarray(_np(dec["embed_out"]["w"]).T)
    dl = dec["layers"]
    for i in range(_np(dl["fc1"]["w"]).shape[0]):
        p = f"decoder.layers.{i}"
        for attn, public in (("self_attn", "self_attn"), ("cross_attn", "encoder_attn")):
            for k, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
                _unlinear(sd, f"{p}.{public}.{name}", dl[attn][k], i)
        _unnorm(sd, f"{p}.self_attn_layer_norm", dl["self_norm"], i)
        _unnorm(sd, f"{p}.encoder_attn_layer_norm", dl["cross_norm"], i)
        _unnorm(sd, f"{p}.final_layer_norm", dl["final_norm"], i)
        _unlinear(sd, f"{p}.fc1", dl["fc1"], i)
        _unlinear(sd, f"{p}.fc2", dl["fc2"], i)
    return sd
