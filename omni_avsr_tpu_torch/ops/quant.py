"""Weight-only int8 quantization of the decode weights (port of the host-side
half of `omni_avsr_tpu/ops/quant.py`).

Leaf format {"w": int8 (in, out), "s": f32 (out,)}: symmetric per output
channel, scale = max(|w|) / 127 over the input axis, codes round half to
even. Stacked (L, in, out) weights quantize per layer. The codes and scales
are bit-identical to the JAX package's.
"""

from __future__ import annotations

from typing import Dict

import torch


def quantize_per_channel(w: torch.Tensor, bits: int = 8) -> Dict[str, torch.Tensor]:
    """(..., in, out) float -> {"w": int8, "s": f32 (..., out)}."""
    qmax = float(2 ** (bits - 1) - 1)
    wf = w.float()
    amax = wf.abs().amax(dim=-2)
    scale = torch.clamp(amax / qmax, min=1e-12)
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -qmax, qmax).to(torch.int8)
    return {"w": q, "s": scale}


def quantize_llm_params(params: Dict) -> Dict:
    """int8 for the LLM layers' attn/mlp matrices and an int8 unembedding
    copy under "lm_head" (tied models); LoRA, norms and the embedding table
    stay as they are."""
    out = dict(params)
    layers = dict(params["layers"])
    for blk_name in ("attn", "mlp"):
        blk = dict(layers[blk_name])
        for k, leaf in blk.items():
            blk[k] = {**leaf, **quantize_per_channel(leaf["w"])}
        layers[blk_name] = blk
    out["layers"] = layers
    if "lm_head" in params:
        out["lm_head"] = quantize_per_channel(params["lm_head"]["w"])
    else:
        out["lm_head"] = quantize_per_channel(params["embed"]["w"].t())
    return out


def quantize_tower_params(params: Dict) -> Dict:
    """int8 for an encoder tower's stacked (L, in, out) matrices under
    "layers"; conv weights, norms, biases and LoRA adapters stay put."""

    def walk(node, in_layers: bool):
        if not isinstance(node, dict):
            return node
        w = node.get("w")
        if in_layers and isinstance(w, torch.Tensor) and w.ndim == 3 and w.dtype != torch.int8:
            return {**node, **quantize_per_channel(w)}
        return {k: (v if k == "lora" else walk(v, in_layers or k == "layers"))
                for k, v in node.items()}

    return walk(params, False)


def fuse_decode_projections(llm: Dict) -> Dict:
    """Concatenate q|k|v and gate|up along the output axis: the decode step
    streams 4 weight buffers per layer instead of 7, with the same values
    (output columns are computed independently)."""

    def cat(entries):
        keys = entries[0].keys()
        assert all(e.keys() == keys for e in entries), "mismatched leaves"
        return {k: torch.cat([e[k] for e in entries], dim=-1) for k in keys}

    out = dict(llm)
    layers = dict(llm["layers"])
    attn = dict(layers["attn"])
    attn["qkv"] = cat([attn.pop("q"), attn.pop("k"), attn.pop("v")])
    layers["attn"] = attn
    mlp = dict(layers["mlp"])
    mlp["gateup"] = cat([mlp.pop("gate"), mlp.pop("up")])
    layers["mlp"] = mlp
    out["layers"] = layers
    return out


def quantize_for_decode(merged: Dict, mode: str) -> Dict:
    """"int8": weight-only int8 on the LLM (q|k|v and gate|up fused) and on
    the Whisper and AV-HuBERT layer stacks. Other modes are not ported."""
    if not mode:
        return merged
    if mode != "int8":
        raise ValueError(f"quantize mode {mode!r}: the port has int8 only")
    out = dict(merged)
    out["llm"] = fuse_decode_projections(quantize_llm_params(merged["llm"]))
    for tower in ("whisper", "avhubert"):
        if tower in merged:
            out[tower] = quantize_tower_params(merged[tower])
    return out
