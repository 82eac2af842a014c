"""Llama decoder with Omni-LoRA: the training and decode paths of
`omni_avsr_tpu/models/llm.py` (reference `Omni_AVSR/Llama_LoRA.py`).

  - `llm_backbone` runs the causal stack for training, each layer under
    `torch.utils.checkpoint` when `remat` (the JAX package's "full" remat
    policy); on the card, at T >= FLASH_MIN_T_TRAIN and head dim 64 or
    128, its attention is the trainable flash kernel (B3 causal forward,
    B4 backward), else dense with a causal mask; `llm_span_stats` puts
    only the label-active span through the lm_head and the CE;
  - `llm_prefill_masked` runs the gap-tolerant prefix once and fills a
    static KV cache;
  - `llm_decode_step_beam_anc` is one beam step on the no-reorder ancestor
    cache: the generated K/V stay in the row that wrote them, an ancestor
    table says which row holds each beam's token at each slot, and the
    attention runs in `ops/beam_attention.py` (the kernel on the card).

LoRA (`Llama_LoRA.py:246-262`): q += s * up_q(down_q(x)), v += s * up_v(down_v(x))
with s = alpha / rank_divisor and the task's own adapter.

Unlike the JAX package, the generated-token cache is updated in place
(one slot per step): it saves a copy of the whole cache per step.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import LLMConfig
from ..data.tokenizer import IGNORE_INDEX
from ..ops.attention import FLASH_MIN_T_TRAIN, NEG_INF, causal_mask, dot_product_attention
from ..ops.beam_attention import beam_decode_attention
from ..ops.flash_attention_bwd import flash_attention_trainable
from ..ops.norms import rms_norm
from ..ops.quant import quantized_matmul, quantized_matmul4
from ..ops.rope import apply_rope, rope_cos_sin
from .common import Params, layer_slice, linear


def unstack_layers(params: Params, cfg: LLMConfig) -> List[Params]:
    """The (L, ...)-stacked layer tree as a list of per-layer trees."""
    return [layer_slice(params["layers"], i) for i in range(cfg.num_layers)]


def _lora_delta(x: torch.Tensor, adapter: Params, scaling: float) -> Tuple[torch.Tensor, torch.Tensor]:
    dq = linear(linear(x, adapter["down_q"]), adapter["up_q"])
    dv = linear(linear(x, adapter["down_v"]), adapter["up_v"])
    return dq * scaling, dv * scaling


def _qkv_with_lora(layer: Params, cfg: LLMConfig, x: torch.Tensor,
                   modality: Optional[str]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Base q/k/v projections (fused q|k|v in decode trees) plus the LoRA
    q/v deltas of the task's adapter."""
    attn = layer["attn"]
    if "qkv" in attn:
        qkv = linear(x, attn["qkv"])
        q, k, v = torch.split(qkv, [cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
    else:
        q, k, v = linear(x, attn["q"]), linear(x, attn["k"]), linear(x, attn["v"])
    if cfg.lora is not None:
        scaling = cfg.lora.scaling
        if cfg.lora.task_specific:
            assert modality is not None, "task-specific LoRA needs a modality"
            dq, dv = _lora_delta(x, layer["lora"][modality], scaling)
            if cfg.lora.shared:
                dqs, dvs = _lora_delta(x, layer["lora_shared"], scaling)
                dq, dv = dq + dqs, dv + dvs
        else:
            dq, dv = _lora_delta(x, layer["lora"], scaling)
        q = q + dq
        v = v + dv
    return q, k, v


def _mlp_block(layer: Params, x: torch.Tensor) -> torch.Tensor:
    mlp = layer["mlp"]
    if "gateup" in mlp:
        g, u = torch.chunk(linear(x, mlp["gateup"]), 2, dim=-1)
    else:
        g, u = linear(x, mlp["gate"]), linear(x, mlp["up"])
    return linear(F.silu(g) * u, mlp["down"])


def embed_tokens(params: Params, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return F.embedding(ids, params["embed"]["w"]).to(dtype)


def lm_head(params: Params, cfg: LLMConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm + unembedding -> f32 logits. An explicit "lm_head" (the
    int8 or packed-int4 copy installed by ops/quant.py) wins over the tied
    embeddings and goes through B2 or B6 with an f32 result
    (`omni_avsr_tpu/models/llm.py:287-312`)."""
    x = rms_norm(x, params["final_norm"]["scale"], cfg.rms_norm_eps)
    head = params.get("lm_head")
    if head is None:  # tied bf16 embeddings: bf16 operands, f32 product
        w = params["embed"]["w"].t().to(x.dtype)
        return torch.matmul(x.float(), w.float())
    xm = x.reshape(-1, x.shape[-1]).contiguous()
    if "w4" in head or "w4c" in head:
        logits = quantized_matmul4(xm, head, out_dtype=torch.float32)
    elif "wc" in head or head["w"].dtype == torch.int8:
        logits = quantized_matmul(xm, head, out_dtype=torch.float32)
    else:
        logits = torch.matmul(xm.float(), head["w"].to(x.dtype).float())
    return logits.reshape(*x.shape[:-1], -1)


def _decoder_layer(layer: Params, cfg: LLMConfig, x: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor, mask: Optional[torch.Tensor], modality: Optional[str],
                   flash_causal: bool) -> torch.Tensor:
    """One pre-norm layer over the whole (B, T, H) sequence (training)."""
    B, T, _ = x.shape
    h = rms_norm(x, layer["input_norm"]["scale"], cfg.rms_norm_eps)
    q, k, v = _qkv_with_lora(layer, cfg, h, modality)
    q = q.reshape(B, T, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    q, k = apply_rope(q, k, cos, sin)
    if flash_causal:
        out = flash_attention_trainable(q, k, v, causal=True)
    else:
        out = dot_product_attention(q, k, v, mask=mask)
    x = x + linear(out.reshape(B, T, cfg.q_dim), layer["attn"]["o"])
    h = rms_norm(x, layer["post_attn_norm"]["scale"], cfg.rms_norm_eps)
    return x + _mlp_block(layer, h)


def llm_backbone(params: Params, cfg: LLMConfig, inputs_embeds: torch.Tensor,
                 positions: torch.Tensor, modality: Optional[str] = None,
                 remat: bool = True) -> torch.Tensor:
    """The causal decoder stack over (B, T, H) embeddings at (B, T) rope
    positions; returns the final hidden states before the final norm
    (`omni_avsr_tpu/models/llm.py:316-372`, without its pipeline route).
    With `remat` and grad enabled, each layer runs under
    `torch.utils.checkpoint` (non-reentrant): its forward runs again in the
    backward, flash kernel included (`maybe_remat`'s "full" policy,
    `:390-409`)."""
    B, T, _ = inputs_embeds.shape
    cos, sin = rope_cos_sin(cfg, positions)
    flash_causal = inputs_embeds.is_cuda and cfg.head_dim in (64, 128) and T >= FLASH_MIN_T_TRAIN
    mask = None if flash_causal else causal_mask(T, T, device=inputs_embeds.device)
    x = inputs_embeds
    for layer in unstack_layers(params, cfg):
        if remat and torch.is_grad_enabled():
            x = checkpoint(_decoder_layer, layer, cfg, x, cos, sin, mask, modality, flash_causal,
                           use_reentrant=False)
        else:
            x = _decoder_layer(layer, cfg, x, cos, sin, mask, modality, flash_causal)
    return x


def token_ce_stats(logits: torch.Tensor, targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (sum of -log p, valid-token count) for logits (B, N, V)
    aligned 1:1 with targets (B, N); IGNORE_INDEX targets add exactly 0
    (`:427-440`)."""
    valid = targets != IGNORE_INDEX
    safe = torch.where(valid, targets, torch.zeros_like(targets))
    logp = torch.log_softmax(logits.float(), dim=-1)
    token_lp = torch.gather(logp, -1, safe[..., None].long())[..., 0]
    total = torch.where(valid, -token_lp, torch.zeros_like(token_lp)).sum(dim=1)
    return total, valid.sum(dim=1)


def llm_span_stats(params: Params, cfg: LLMConfig, inputs_embeds: torch.Tensor,
                   labels: torch.Tensor, span: Tuple[int, int], modality: Optional[str] = None,
                   remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shifted-CE stats over the label-active logits positions [t0, t1)
    only: the backbone runs the whole sequence, the final norm, lm_head and
    CE only the span (`:451-475`; exact, since the other positions' labels
    are IGNORE_INDEX)."""
    B, T, _ = inputs_embeds.shape
    t0, t1 = span
    positions = torch.arange(T, device=inputs_embeds.device)[None].expand(B, T)
    x = llm_backbone(params, cfg, inputs_embeds, positions, modality, remat)
    logits = lm_head(params, cfg, x[:, t0:t1])
    return token_ce_stats(logits, labels[:, t0 + 1:t1 + 1])


class KVCache(NamedTuple):
    """Prefill cache, stacked over layers: (L, B, S, Hkv, D)."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(cls, cfg: LLMConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> "KVCache":
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def llm_prefill_masked(
    params: Params,
    cfg: LLMConfig,
    inputs_embeds: torch.Tensor,  # (B, P, H)
    key_valid: torch.Tensor,  # (B, P) bool: which prefix slots are real tokens
    positions: torch.Tensor,  # (B, P) int: rope positions (gaps collapsed)
    last_idx: torch.Tensor,  # (B,) slot of the final prefix token
    cache: KVCache,
    modality: Optional[str] = None,
    layers: Optional[List[Params]] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """Gap-tolerant prefill: invalid slots never act as keys. Fills the
    cache in place and returns the (B, V) f32 logits at `last_idx`."""
    B, P, _ = inputs_embeds.shape
    layers = layers if layers is not None else unstack_layers(params, cfg)
    cos, sin = rope_cos_sin(cfg, positions)
    S = cache.k.shape[2]
    kv = F.pad(key_valid, (0, S - P))
    qmask = causal_mask(P, S, device=kv.device) & kv[:, None, None, :]
    x = inputs_embeds
    for i, layer in enumerate(layers):
        h = rms_norm(x, layer["input_norm"]["scale"], cfg.rms_norm_eps)
        q, k, v = _qkv_with_lora(layer, cfg, h, modality)
        q = q.reshape(B, P, cfg.num_heads, cfg.head_dim)
        k = k.reshape(B, P, cfg.num_kv_heads, cfg.head_dim)
        v = v.reshape(B, P, cfg.num_kv_heads, cfg.head_dim)
        q, k = apply_rope(q, k, cos, sin)
        cache.k[i, :, :P] = k.to(cache.k.dtype)
        cache.v[i, :, :P] = v.to(cache.v.dtype)
        out = dot_product_attention(q, cache.k[i].to(q.dtype), cache.v[i].to(q.dtype), mask=qmask)
        x = x + linear(out.reshape(B, P, cfg.q_dim), layer["attn"]["o"])
        h = rms_norm(x, layer["post_attn_norm"]["scale"], cfg.rms_norm_eps)
        x = x + _mlp_block(layer, h)
    x_last = x[torch.arange(B, device=x.device), last_idx][:, None]  # (B, 1, H)
    return lm_head(params, cfg, x_last)[:, 0], cache


class AncSplitCache(NamedTuple):
    """Beam cache for the ancestor route: the prefix once per batch item,
    (L, B, Hkv, P, D), and the generated tokens UNPERMUTED,
    (L, B, Hkv, K, N, D): row k slot n holds what beam row k wrote at step n."""

    prefix_k: torch.Tensor
    prefix_v: torch.Tensor
    gen_k: torch.Tensor
    gen_v: torch.Tensor

    @classmethod
    def from_prefill(cls, cache: KVCache, prefix_pad: int, num_beams: int,
                     max_new: int) -> "AncSplitCache":
        L, B, S, H, D = cache.k.shape
        zeros = cache.k.new_zeros((L, B, H, num_beams, max_new, D))
        pk = cache.k[:, :, :prefix_pad].permute(0, 1, 3, 2, 4).contiguous()
        pv = cache.v[:, :, :prefix_pad].permute(0, 1, 3, 2, 4).contiguous()
        return cls(pk, pv, zeros, torch.zeros_like(zeros))

    def append_(self, layer: int, k: torch.Tensor, v: torch.Tensor, step: int,
                num_beams: int) -> None:
        """Write one layer's (B*K, Hkv, D) token K/V at slot `step`, in place."""
        BK, Hkv, D = k.shape
        B = BK // num_beams
        self.gen_k[layer, :, :, :, step] = k.reshape(B, num_beams, Hkv, D).transpose(1, 2).to(self.gen_k.dtype)
        self.gen_v[layer, :, :, :, step] = v.reshape(B, num_beams, Hkv, D).transpose(1, 2).to(self.gen_v.dtype)


def update_ancestors(anc: torch.Tensor, flat_idx: torch.Tensor, step: int,
                     num_beams: int) -> torch.Tensor:
    """Advance the (B, K, N) ancestor table by one selection round: beam k
    inherits its parent's chain and owns row k at slot `step`."""
    B, K, N = anc.shape
    parent = flat_idx.reshape(B, K) - (torch.arange(B, device=anc.device) * K)[:, None]
    anc = torch.gather(anc, 1, parent[:, :, None].expand(B, K, N)).clone()
    anc[:, :, step] = torch.arange(K, dtype=anc.dtype, device=anc.device)[None, :]
    return anc


def llm_decode_step_beam_anc(
    params: Params,
    cfg: LLMConfig,
    token_embeds: torch.Tensor,  # (B*K, 1, H)
    step: int,
    n_valid: torch.Tensor,  # (B*K,) valid prefix tokens (rope positions)
    prefix_mask: torch.Tensor,  # (B, P) bool
    cache: AncSplitCache,
    anc: torch.Tensor,  # (B, K, N) int32, already advanced for this step
    num_beams: int,
    modality: Optional[str] = None,
    layers: Optional[List[Params]] = None,
) -> Tuple[torch.Tensor, AncSplitCache]:
    """One beam step: every layer's attention goes through
    `beam_decode_attention`; this step's K/V land in slot `step` after the
    layer's attention (the current token is its own block there).
    Returns ((B*K, V) f32 logits, cache)."""
    BK = token_embeds.shape[0]
    layers = layers if layers is not None else unstack_layers(params, cfg)
    positions = (n_valid + step)[:, None]
    cos, sin = rope_cos_sin(cfg, positions)
    prefix_bias = torch.where(prefix_mask, 0.0, NEG_INF).float()
    x = token_embeds
    for i, layer in enumerate(layers):
        h = rms_norm(x, layer["input_norm"]["scale"], cfg.rms_norm_eps)
        q, k, v = _qkv_with_lora(layer, cfg, h, modality)
        q = q.reshape(BK, 1, cfg.num_heads, cfg.head_dim)
        k = k.reshape(BK, 1, cfg.num_kv_heads, cfg.head_dim)
        v = v.reshape(BK, 1, cfg.num_kv_heads, cfg.head_dim)
        q, k = apply_rope(q, k, cos, sin)
        k_cur, v_cur = k[:, 0].contiguous(), v[:, 0].contiguous()
        out = beam_decode_attention(
            q.contiguous(), cache.prefix_k[i].to(q.dtype), cache.prefix_v[i].to(q.dtype),
            cache.gen_k[i].to(q.dtype), cache.gen_v[i].to(q.dtype), k_cur, v_cur,
            prefix_bias, anc, step, num_beams)
        cache.append_(i, k_cur, v_cur, step, num_beams)
        x = x + linear(out.reshape(BK, 1, cfg.q_dim), layer["attn"]["o"])
        h2 = rms_norm(x, layer["post_attn_norm"]["scale"], cfg.rms_norm_eps)
        x = x + _mlp_block(layer, h2)
    return lm_head(params, cfg, x)[:, 0], cache
