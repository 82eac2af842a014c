"""Llama decoder with Omni-LoRA: the training and decode paths of
`omni_avsr_tpu/models/llm.py` (reference `Omni_AVSR/Llama_LoRA.py`).

  - `llm_backbone` runs the causal stack for training, each layer under
    the remat policy `remat` (`maybe_remat`: "dots", "off" or "full", the
    JAX package's `OMNI_REMAT`); on the card, at T >= FLASH_MIN_T_TRAIN
    and head dim 64 or 128, its attention is the trainable flash kernel
    (B3 causal forward, B4 backward), else dense with a causal mask;
    `llm_span_stats` puts only the label-active span through the lm_head
    and the CE; `llm_logits` / `llm_loss` run the whole sequence through
    it (the HF CausalLM loss, `causal_lm_loss`), and an explicit mask
    takes the plain attention;
  - `llm_prefill_masked` runs the gap-tolerant prefix once and fills a
    static KV cache; `llm_prefill` is its contiguous-prefix form;
  - `llm_decode_step_beam_anc` is one beam step on the no-reorder ancestor
    cache: the generated K/V stay in the row that wrote them, an ancestor
    table says which row holds each beam's token at each slot, and the
    attention runs in `ops/beam_attention.py` (the kernel on the card);
  - `llm_decode_step_beam` is the JAX package's other route, its "xla"
    one: the generated K/V are reordered by parent beam every step
    (`SplitCache.reorder_`, one row gather) and the attention is the
    three-block joint softmax of `_merged_beam_attention` in torch ops;
  - `llm_decode_step` is one step on the contiguous KV cache.

LoRA (`Llama_LoRA.py:246-262`): q += s * up_q(down_q(x)), v += s * up_v(down_v(x))
with s = alpha / rank_divisor and the task's own adapter; with the modality
`FUSED3` the batch is the three tasks stacked and each third takes its own.

Unlike the JAX package, the generated-token cache is updated in place
(one slot per step): it saves a copy of the whole cache per step.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..config import MODALITIES, LLMConfig
from ..data.tokenizer import IGNORE_INDEX
from ..ops.attention import FLASH_MIN_T_TRAIN, NEG_INF, causal_mask, dot_product_attention
from ..ops.beam_attention import beam_decode_attention
from ..ops.flash_attention_bwd import flash_attention_trainable
from ..ops.norms import rms_norm
from ..ops.quant import quantized_matmul, quantized_matmul4
from ..ops.rope import apply_rope, rope_cos_sin
from ..parallel import collectives as par
from .common import Params, layer_slice, linear
from .moe import moe_ffn


def unstack_layers(params: Params, cfg: LLMConfig) -> List[Params]:
    """The (L, ...)-stacked layer tree as a list of per-layer trees."""
    return [layer_slice(params["layers"], i) for i in range(cfg.num_layers)]


def _lora_delta(x: torch.Tensor, adapter: Params, scaling: float,
                tp: Optional[par.Axis] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The adapter's q/v deltas; under tensor parallelism the ups are the
    rank's column slices and the (replicated) downs' grads are summed over
    tp (`par.copy_to` on their weights: each rank's grad is the part its
    heads give)."""
    down_q, down_v = adapter["down_q"], adapter["down_v"]
    if tp is not None:
        down_q = {**down_q, "w": par.copy_to(down_q["w"], tp)}
        down_v = {**down_v, "w": par.copy_to(down_v["w"], tp)}
    dq = linear(linear(x, down_q), adapter["up_q"])
    dv = linear(linear(x, down_v), adapter["up_v"])
    return dq * scaling, dv * scaling


def local_heads(cfg: LLMConfig) -> Tuple[int, int]:
    """(query heads, kv heads) this rank runs: all of them, or its 1/tp of
    each when the attention block runs tensor-parallel."""
    tp = par.tp_axis("llm.attn")
    n = tp.size if tp is not None else 1
    return cfg.num_heads // n, cfg.num_kv_heads // n


# The MoE FFN's block name: it never runs tensor-parallel (its experts
# replicate over tp and shard over ep only), so `par.tp_axis(MOE_BLOCK)` is
# None in every scope.
MOE_BLOCK = "llm.moe"


def _enter(x: torch.Tensor, block: str) -> torch.Tensor:
    """A block's input. Under sequence parallelism, x over the whole of T
    from this rank's slice: a tensor-parallel block's rank computes its own
    part of the objective, so the gradient is reduce-scattered ("sum"); a
    replicated block runs the whole of T on every tp rank, each of which
    then holds the whole output gradient and keeps its own slice ("slice").
    Else, under tensor parallelism, x with its gradient summed over tp, each
    rank's being the part its columns give. `_leave` is the matching exit."""
    tp, sp = par.tp_axis(block), par.sp_axis()
    if sp is not None:
        return par.gather(x, sp, 1, grad="sum" if tp is not None else "slice")
    return par.copy_to(x, tp)


def _leave(y: torch.Tensor, block: str) -> torch.Tensor:
    """A block's output -> the residual stream. Tensor-parallel (a row-split
    linear's partial sums): an all-reduce over tp, or a reduce-scatter over
    T under sequence parallelism. Replicated: as it is, or this rank's slice
    of T under sequence parallelism (the backward all-gathers the slices,
    so every tp rank computes the same whole weight grads)."""
    tp, sp = par.tp_axis(block), par.sp_axis()
    if sp is not None:
        return par.reduce_scatter(y, sp, 1) if tp is not None else par.scatter(y, sp, 1)
    return par.reduce_from(y, tp) if tp is not None else y


# The modality of the fused three-task training forward: the rows of x are
# the three tasks' batches stacked [audio | video | audiovisual], x.shape[0]
# // 3 each, and each block takes its own task's adapter
# (`omni_avsr_tpu/models/llm.py:146-150`; `models/omni.py::_fused_train_losses`).
FUSED3 = "__fused3__"


def _qkv_with_lora(layer: Params, cfg: LLMConfig, x: torch.Tensor,
                   modality: Optional[str]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Base q/k/v projections (fused q|k|v in decode trees) plus the LoRA
    q/v deltas of the task's adapter. With `FUSED3` the base projections
    run once over the stacked (3B, T, H) batch and each task block adds its
    own adapter's deltas (`omni_avsr_tpu/models/llm.py:153-200`)."""
    attn = layer["attn"]
    tp = par.tp_axis("llm.attn")
    x = _enter(x, "llm.attn")
    if "qkv" in attn:
        qkv = linear(x, attn["qkv"])
        hq, hkv = local_heads(cfg)
        q, k, v = torch.split(qkv, [hq * cfg.head_dim, hkv * cfg.head_dim,
                                    hkv * cfg.head_dim], dim=-1)
    else:
        q, k, v = linear(x, attn["q"]), linear(x, attn["k"]), linear(x, attn["v"])
    if cfg.lora is not None:
        scaling = cfg.lora.scaling
        if cfg.lora.task_specific:
            assert modality is not None, "task-specific LoRA needs a modality"
            if modality == FUSED3:
                deltas = [_lora_delta(xm, layer["lora"][m], scaling, tp)
                          for xm, m in zip(torch.chunk(x, 3, dim=0), MODALITIES)]
                dq = torch.cat([d[0] for d in deltas], dim=0)
                dv = torch.cat([d[1] for d in deltas], dim=0)
            else:
                dq, dv = _lora_delta(x, layer["lora"][modality], scaling, tp)
            if cfg.lora.shared:
                dqs, dvs = _lora_delta(x, layer["lora_shared"], scaling, tp)
                dq, dv = dq + dqs, dv + dvs
        else:
            dq, dv = _lora_delta(x, layer["lora"], scaling, tp)
        q = q + dq
        v = v + dv
    return q, k, v


def _mlp_block(layer: Params, x: torch.Tensor, cfg: LLMConfig,
               n_real: Optional[int] = None) -> torch.Tensor:
    """The layer's SwiGLU MLP (fused gate|up in decode trees), or its MoE FFN
    when the layer has one (`cfg.moe_experts > 0`, `models/moe.py`; the
    aux loss is dropped, as the JAX decoder drops it,
    `omni_avsr_tpu/models/llm.py:244-252`). The MoE routes every row of
    `x` together, in `x.reshape(-1, H)` order, as the JAX decoder does;
    under sequence parallelism x holds T padded past the `n_real` real
    positions, and only the real ones are routed (padding rows would take
    capacity and expert slots), the output padded back with zeros."""
    if "moe" in layer:
        x = _enter(x, MOE_BLOCK)
        T = x.shape[1]
        n = T if n_real is None else n_real
        y, _ = moe_ffn(layer["moe"], x[:, :n], cfg.moe_capacity_factor, cfg.moe_routing)
        return _leave(F.pad(y, (0, 0, 0, T - n)), MOE_BLOCK)
    mlp = layer["mlp"]
    x = _enter(x, "llm.mlp")
    if "gateup" in mlp:
        g, u = torch.chunk(linear(x, mlp["gateup"]), 2, dim=-1)
    else:
        g, u = linear(x, mlp["gate"]), linear(x, mlp["up"])
    return _leave(linear(F.silu(g) * u, mlp["down"]), "llm.mlp")


def embed_tokens(params: Params, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return F.embedding(ids, params["embed"]["w"]).to(dtype)


def lm_head(params: Params, cfg: LLMConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm + unembedding -> f32 logits. An explicit "lm_head" (the
    int8 or packed-int4 copy installed by ops/quant.py) wins over the tied
    embeddings and goes through B2 or B6 with an f32 result
    (`omni_avsr_tpu/models/llm.py:287-312`). Under tensor parallelism an
    explicit head gives this rank's vocabulary slice (`gather_vocab`)."""
    x = rms_norm(x, params["final_norm"]["scale"], cfg.rms_norm_eps)
    head = params.get("lm_head")
    if head is None:  # tied bf16 embeddings: bf16 operands, f32 product
        w = params["embed"]["w"].t().to(x.dtype)
        return torch.matmul(x.float(), w.float())
    x = par.copy_to(x, par.tp_axis("llm.lm_head"))
    xm = x.reshape(-1, x.shape[-1]).contiguous()
    if "w4" in head or "w4c" in head:
        logits = quantized_matmul4(xm, head, out_dtype=torch.float32)
    elif "wc" in head or head["w"].dtype == torch.int8:
        logits = quantized_matmul(xm, head, out_dtype=torch.float32)
    else:
        logits = torch.matmul(xm.float(), head["w"].to(x.dtype).float())
    return logits.reshape(*x.shape[:-1], -1)


def gather_vocab(logits: torch.Tensor, cfg: LLMConfig) -> torch.Tensor:
    """Logits over the whole vocabulary: the ranks' slices all-gathered
    when the head runs tensor-parallel (the consumer runs replicated, so
    each rank's gradient is its own slice)."""
    if logits.shape[-1] == cfg.vocab_size:
        return logits
    return par.gather(logits, par.tp_axis("llm.lm_head"), -1, grad="slice")


def _decoder_layer(layer: Params, cfg: LLMConfig, x: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor, mask: Optional[torch.Tensor], modality: Optional[str],
                   flash_causal: bool, n_real: int) -> torch.Tensor:
    """One pre-norm layer over the whole (B, T, H) sequence (training), of
    which the first `n_real` positions are real. Under sequence parallelism
    x is this rank's slice of T: the norms run on it, and each block
    gathers its input over T (`_enter`) and leaves through `_leave`."""
    layer = par.fsdp_layer(layer)
    sp = par.sp_axis()

    def norm(x, p):  # under SP a norm's scale sees this rank's rows only
        return rms_norm(x, par.copy_to(p["scale"], sp), cfg.rms_norm_eps)

    q, k, v = _qkv_with_lora(layer, cfg, norm(x, layer["input_norm"]), modality)
    B, T = q.shape[:2]
    hq, hkv = local_heads(cfg)
    q = q.reshape(B, T, hq, cfg.head_dim)
    k = k.reshape(B, T, hkv, cfg.head_dim)
    v = v.reshape(B, T, hkv, cfg.head_dim)
    q, k = apply_rope(q, k, cos, sin)
    if flash_causal:
        out = flash_attention_trainable(q, k, v, causal=True)
    else:
        out = dot_product_attention(q, k, v, mask=mask)
    x = x + _leave(linear(out.reshape(B, T, -1), layer["attn"]["o"]), "llm.attn")
    return x + _mlp_block(layer, norm(x, layer["post_attn_norm"]), cfg, n_real)


REMAT_POLICIES = ("dots", "off", "full")

# the products `checkpoint_dots_with_no_batch_dims` saves: matrix products
# without batch dimensions (every linear; not the attention's batched ones)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def check_remat(remat: str) -> str:
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat {remat!r}: one of {REMAT_POLICIES}")
    return remat


def maybe_remat(fn, remat: str, *args):
    """`fn(*args)` under a remat policy, the JAX package's `maybe_remat`
    (`omni_avsr_tpu/models/llm.py:390-408`, its `OMNI_REMAT`):
      "dots" (the default there) keeps the outputs of the matrix products
        without batch dimensions and recomputes the rest in the backward
        (`checkpoint_dots_with_no_batch_dims`, here a selective checkpoint
        whose policy saves `aten.mm` / `aten.addmm`);
      "off"  checkpoints nothing;
      "full" recomputes the whole of `fn` in the backward.
    Under "dots" and "full" a kernel inside `fn` (the flash forward B3)
    runs again in the backward. Nothing is checkpointed without grad. The
    recompute runs inside the backward, which on the card runs on the
    autograd engine's device thread, outside the caller's parallel scope
    (`parallel/collectives.py::scope`): `fn` takes that scope with it."""
    check_remat(remat)
    if remat == "off" or not torch.is_grad_enabled():
        return fn(*args)
    scope = par.current()
    if scope is not None:
        fn = functools.partial(_in_scope, scope, fn)
    if remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                   _dots_policy))


def flash_causal_gate(T: int, head_dim: int, on_card: bool) -> bool:
    """Whether a causal stack over T real positions runs the flash kernels
    (B3 forward, B4 backward): on the card, at head dim 64 or 128, from
    FLASH_MIN_T_TRAIN positions. Under sequence parallelism T is the
    unpadded length, as the JAX gate sees the global T
    (`omni_avsr_tpu/models/llm.py:345-351`)."""
    return on_card and head_dim in (64, 128) and T >= FLASH_MIN_T_TRAIN


def pad_mask(mask: torch.Tensor, Tp: int) -> torch.Tensor:
    """A bool (..., T, T) attention mask at Tp >= T positions: the padding
    keys masked for every row, and each padding query attending to itself
    (no row is all -inf, so no NaN reaches a gradient)."""
    T = mask.shape[-1]
    out = mask.new_zeros((*mask.shape[:-2], Tp, Tp))
    out[..., :T, :T] = mask
    pad = torch.arange(T, Tp, device=mask.device)
    out[..., pad, pad] = True
    return out


def _in_scope(scope: par.Parallel, fn, *args):
    with par.scope(scope):
        return fn(*args)


def run_layers(layers: Params, cfg: LLMConfig, inputs_embeds: torch.Tensor,
               positions: torch.Tensor, modality: Optional[str] = None,
               remat: str = "dots", mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The stack of `layers` (an (L', ...)-stacked tree: the whole decoder,
    or a pipeline stage's slice) over (B, T, H) at (B, T) rope positions,
    causal unless `mask` (bool (B, 1, T, T), True = attend) is given, which
    then takes the plain attention in every layer. Under sequence
    parallelism T is padded to a multiple of tp (an explicit mask by
    `pad_mask`), the residual stream between layers is this rank's slice
    of T, and the padding is sliced off at the end (it reaches no real
    row)."""
    check_remat(remat)
    B, T, _ = inputs_embeds.shape
    flash_causal = mask is None and flash_causal_gate(T, cfg.head_dim, inputs_embeds.is_cuda)
    sp = par.sp_axis()
    x, Tp = inputs_embeds, T
    if sp is not None:
        Tp = -(-T // sp.size) * sp.size
        if Tp != T:
            x = F.pad(x, (0, 0, 0, Tp - T))
            positions = torch.cat([positions, positions[:, -1:] + torch.arange(
                1, Tp - T + 1, device=positions.device)[None]], dim=1)
            if mask is not None:
                mask = pad_mask(mask, Tp)
        x = par.scatter(x, sp, 1)
    cos, sin = rope_cos_sin(cfg, positions)
    if mask is None and not flash_causal:
        mask = causal_mask(Tp, Tp, device=inputs_embeds.device)
    n = next(iter(_stacked_leaves(layers))).shape[0]
    for i in range(n):
        x = maybe_remat(_decoder_layer, remat, layer_slice(layers, i), cfg, x, cos, sin, mask,
                        modality, flash_causal, T)
    if sp is not None:
        x = par.gather(x, sp, 1, grad="slice")[:, :T]
    return x


def _stacked_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _stacked_leaves(v)
        else:
            yield v


def llm_backbone(params: Params, cfg: LLMConfig, inputs_embeds: torch.Tensor,
                 positions: torch.Tensor, modality: Optional[str] = None,
                 remat: str = "dots", pipeline=None,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The decoder stack over (B, T, H) embeddings at (B, T) rope
    positions; returns the final hidden states before the final norm
    (`omni_avsr_tpu/models/llm.py:316-372`). Causal when `mask` is None
    (the flash kernels on the card at T >= FLASH_MIN_T_TRAIN and head dim
    64 or 128, as the JAX gate sends it there); an explicit bool mask
    (B, 1, T, T) takes the plain attention. Each layer runs under the
    remat policy `remat` (`maybe_remat`); the values are the same under
    every policy. With a `PipelinePlan` the stack runs the GPipe schedule
    over the plan's pp axis (`parallel/pipeline.py`; `params["layers"]` is
    then this stage's slice; causal only)."""
    check_remat(remat)
    if pipeline is not None:
        if mask is not None:
            raise ValueError("pipelined backbone supports the pure-causal training path only "
                             "(mask must be None)")
        from ..parallel.pipeline import pipeline_backbone

        return pipeline_backbone(
            pipeline.mesh, params["layers"], cfg, inputs_embeds, positions, modality=modality,
            num_microbatches=pipeline.num_microbatches, remat=remat,
            axis_name=pipeline.axis, dp_axis=pipeline.dp_axis)
    return run_layers(params["layers"], cfg, inputs_embeds, positions, modality, remat, mask)


def llm_logits(params: Params, cfg: LLMConfig, inputs_embeds: torch.Tensor,
               positions: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
               modality: Optional[str] = None, remat: str = "dots") -> torch.Tensor:
    """The backbone, then `lm_head`: f32 logits (B, T, V)
    (`omni_avsr_tpu/models/llm.py:411-422`). `positions` default to
    arange(T) in every row; `mask` as in `llm_backbone` (None: causal, on
    the card through B3 forward and B4 backward where the gate admits it).
    The JAX function's `remat: bool` is the port's policy string: True
    there is the policy its `OMNI_REMAT` names ("dots" by default), False
    is "off"."""
    B, T, _ = inputs_embeds.shape
    if positions is None:
        positions = torch.arange(T, device=inputs_embeds.device)[None].expand(B, T)
    x = llm_backbone(params, cfg, inputs_embeds, positions, modality, remat, mask=mask)
    return gather_vocab(lm_head(params, cfg, x), cfg)


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


def causal_lm_token_stats(logits: torch.Tensor,
                          labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (sum of -log p, valid-token count) of the HF CausalLM loss:
    logits[:, t] predict labels[:, t + 1] (`:443-448`)."""
    return token_ce_stats(logits[:, :-1], labels[:, 1:])


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The HF CausalLM loss: shift by one, the f32 mean of the CE over the
    labels != IGNORE_INDEX, at least one in the denominator (`:478-481`)."""
    total, count = causal_lm_token_stats(logits, labels)
    return total.sum() / count.sum().clamp(min=1)


def llm_loss(params: Params, cfg: LLMConfig, inputs_embeds: torch.Tensor, labels: torch.Tensor,
             modality: Optional[str] = None, remat: str = "dots") -> torch.Tensor:
    """The whole-sequence training loss of the reference's LLM
    (`modeling_OmniAVSR.py:263-306`, `omni_avsr_tpu/models/llm.py:484-497`):
    pure causal masking, since the reference passes no attention mask with
    its right-padded embeddings and -100 labels; on the card at T >= 256
    every layer's attention is B3 forward and B4 backward."""
    logits = llm_logits(params, cfg, inputs_embeds, modality=modality, remat=remat)
    return causal_lm_loss(logits, labels)


def llm_span_stats(params: Params, cfg: LLMConfig, inputs_embeds: torch.Tensor,
                   labels: torch.Tensor, span: Tuple[int, int], modality: Optional[str] = None,
                   remat: str = "dots", pipeline=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shifted-CE stats over the label-active logits positions [t0, t1)
    only: the backbone runs the whole sequence, the final norm, lm_head and
    CE only the span (`:451-475`; exact, since the other positions' labels
    are IGNORE_INDEX)."""
    B, T, _ = inputs_embeds.shape
    t0, t1 = span
    positions = torch.arange(T, device=inputs_embeds.device)[None].expand(B, T)
    x = llm_backbone(params, cfg, inputs_embeds, positions, modality, remat, pipeline)
    logits = gather_vocab(lm_head(params, cfg, x[:, t0:t1]), cfg)
    return token_ce_stats(logits, labels[:, t0 + 1:t1 + 1])


class KVCache(NamedTuple):
    """Prefill cache, stacked over layers: (L, B, S, Hkv, D)."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(cls, cfg: LLMConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> "KVCache":
        shape = (cfg.num_layers, batch, max_len, local_heads(cfg)[1], cfg.head_dim)
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
    hq, hkv = local_heads(cfg)
    cos, sin = rope_cos_sin(cfg, positions)
    S = cache.k.shape[2]
    kv = F.pad(key_valid, (0, S - P))
    qmask = causal_mask(P, S, device=kv.device) & kv[:, None, None, :]
    x = inputs_embeds
    for i, layer in enumerate(layers):
        h = rms_norm(x, layer["input_norm"]["scale"], cfg.rms_norm_eps)
        q, k, v = _qkv_with_lora(layer, cfg, h, modality)
        q = q.reshape(B, P, hq, cfg.head_dim)
        k = k.reshape(B, P, hkv, cfg.head_dim)
        v = v.reshape(B, P, hkv, cfg.head_dim)
        q, k = apply_rope(q, k, cos, sin)
        cache.k[i, :, :P] = k.to(cache.k.dtype)
        cache.v[i, :, :P] = v.to(cache.v.dtype)
        out = dot_product_attention(q, cache.k[i].to(q.dtype), cache.v[i].to(q.dtype), mask=qmask)
        x = x + _leave(linear(out.reshape(B, P, -1), layer["attn"]["o"]), "llm.attn")
        h = rms_norm(x, layer["post_attn_norm"]["scale"], cfg.rms_norm_eps)
        x = x + _mlp_block(layer, h, cfg)
    x_last = x[torch.arange(B, device=x.device), last_idx][:, None]  # (B, 1, H)
    return lm_head(params, cfg, x_last)[:, 0], cache


def llm_prefill(
    params: Params,
    cfg: LLMConfig,
    inputs_embeds: torch.Tensor,  # (B, P, H) padded prefix
    prefix_len: torch.Tensor,  # (B,) valid lengths (<= P)
    cache: KVCache,
    modality: Optional[str] = None,
    layers: Optional[List[Params]] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """Contiguous-prefix prefill: the valid tokens fill slots [0,
    prefix_len) (`omni_avsr_tpu/models/llm.py:528-546`). Returns the (B, V)
    logits at each row's last valid slot."""
    B, P, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    key_valid = torch.arange(P, device=dev)[None] < prefix_len[:, None]
    positions = torch.arange(P, device=dev)[None].expand(B, P)
    last_idx = torch.clamp(prefix_len - 1, 0, P - 1)
    return llm_prefill_masked(params, cfg, inputs_embeds, key_valid, positions, last_idx, cache,
                              modality, layers=layers)


def llm_decode_step(
    params: Params,
    cfg: LLMConfig,
    token_embeds: torch.Tensor,  # (B, 1, H)
    step: int,  # index of this generated token (0-based)
    prefix_len: torch.Tensor,  # (B,) valid prefix tokens
    prefill_pad: int,  # P: the prefix slots of the cache
    cache: KVCache,
    modality: Optional[str] = None,
    key_valid: Optional[torch.Tensor] = None,  # (B, P) for a gap-tolerant prefix
    layers: Optional[List[Params]] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step on the contiguous cache (`omni_avsr_tpu/models/llm.py:
    857-`): this token's K/V land in slot P + step (in place), its rope
    position is prefix_len + step, and it attends to the valid prefix slots
    and the generated slots up to itself. Returns ((B, V) f32 logits,
    cache)."""
    B = token_embeds.shape[0]
    dev = token_embeds.device
    layers = layers if layers is not None else unstack_layers(params, cfg)
    hq, hkv = local_heads(cfg)
    cos, sin = rope_cos_sin(cfg, (prefix_len + step)[:, None])
    S = cache.k.shape[2]
    key_pos = torch.arange(S, device=dev)[None]
    gen_valid = (key_pos >= prefill_pad) & (key_pos <= prefill_pad + step)
    if key_valid is not None:
        kv_mask = F.pad(key_valid, (0, S - prefill_pad)) | gen_valid
    else:
        kv_mask = (key_pos < prefix_len[:, None]) | gen_valid
    mask = kv_mask[:, None, None, :]
    slot = prefill_pad + step
    x = token_embeds
    for i, layer in enumerate(layers):
        h = rms_norm(x, layer["input_norm"]["scale"], cfg.rms_norm_eps)
        q, k, v = _qkv_with_lora(layer, cfg, h, modality)
        q = q.reshape(B, 1, hq, cfg.head_dim)
        k = k.reshape(B, 1, hkv, cfg.head_dim)
        v = v.reshape(B, 1, hkv, cfg.head_dim)
        q, k = apply_rope(q, k, cos, sin)
        cache.k[i, :, slot] = k[:, 0].to(cache.k.dtype)
        cache.v[i, :, slot] = v[:, 0].to(cache.v.dtype)
        out = dot_product_attention(q, cache.k[i].to(q.dtype), cache.v[i].to(q.dtype), mask=mask)
        x = x + _leave(linear(out.reshape(B, 1, -1), layer["attn"]["o"]), "llm.attn")
        h2 = rms_norm(x, layer["post_attn_norm"]["scale"], cfg.rms_norm_eps)
        x = x + _mlp_block(layer, h2, cfg)
    return lm_head(params, cfg, x)[:, 0], cache


class SplitCache:
    """Beam cache of the reorder route (`omni_avsr_tpu/models/llm.py:
    589-645`): the prefix once per batch item, (L, B, Hkv, P, D), and the
    generated tokens per beam, BEAM-LEADING (B*K, L, Hkv, N, D), so that
    the per-step reorder by parent beam is one gather of whole rows of a
    flattened (B*K, L*Hkv*N*D) view. The gather writes into a second
    buffer made once, and the two swap: no allocation per step. Unlike the
    JAX package's, this cache is updated in place."""

    def __init__(self, prefix_k: torch.Tensor, prefix_v: torch.Tensor, gen_k: torch.Tensor,
                 gen_v: torch.Tensor):
        self.prefix_k, self.prefix_v = prefix_k, prefix_v
        self.gen_k, self.gen_v = gen_k, gen_v
        self._spare_k, self._spare_v = torch.empty_like(gen_k), torch.empty_like(gen_v)

    @classmethod
    def from_prefill(cls, cache: KVCache, prefix_pad: int, num_beams: int,
                     max_new: int) -> "SplitCache":
        L, B, S, H, D = cache.k.shape
        zeros = cache.k.new_zeros((B * num_beams, L, H, max_new, D))
        pk = cache.k[:, :, :prefix_pad].permute(0, 1, 3, 2, 4).contiguous()
        pv = cache.v[:, :, :prefix_pad].permute(0, 1, 3, 2, 4).contiguous()
        return cls(pk, pv, zeros, torch.zeros_like(zeros))

    def reorder_(self, flat_idx: torch.Tensor) -> "SplitCache":
        """Permute the generated region by parent row: row r becomes old row
        flat_idx[r]."""
        BK = self.gen_k.shape[0]
        torch.index_select(self.gen_k.view(BK, -1), 0, flat_idx, out=self._spare_k.view(BK, -1))
        torch.index_select(self.gen_v.view(BK, -1), 0, flat_idx, out=self._spare_v.view(BK, -1))
        self.gen_k, self._spare_k = self._spare_k, self.gen_k
        self.gen_v, self._spare_v = self._spare_v, self.gen_v
        return self

    def append_(self, layer: int, k: torch.Tensor, v: torch.Tensor, step: int) -> None:
        """Write one layer's (B*K, Hkv, D) token K/V at slot `step`."""
        self.gen_k[:, layer, :, step] = k.to(self.gen_k.dtype)
        self.gen_v[:, layer, :, step] = v.to(self.gen_v.dtype)


def merged_beam_attention(
    q: torch.Tensor,  # (B*K, 1, Hq, D)
    pk: torch.Tensor,  # (B, Hkv, P, D) shared prefix keys
    pv: torch.Tensor,
    gk: torch.Tensor,  # (B*K, Hkv, N, D) per-beam generated keys
    gv: torch.Tensor,
    k_cur: torch.Tensor,  # (B*K, Hkv, D) this step's key (not yet in the cache)
    v_cur: torch.Tensor,
    prefix_mask: torch.Tensor,  # (B, P) bool
    gen_mask: torch.Tensor,  # (N,) bool: slots < step
    num_beams: int,
) -> torch.Tensor:
    """Exact attention over [shared prefix | per-beam generated | current
    token]: three logit blocks in f32 (the bf16 products of the JAX einsums
    are exact in f32, so their f32 accumulation is this f32 einsum), one
    joint softmax, the value products in the cache's dtype
    (`omni_avsr_tpu/models/llm.py:701-749`). Torch ops: the JAX package
    computes this route with XLA, outside any Pallas kernel."""
    BK, _, Hq, D = q.shape
    K = num_beams
    B = BK // K
    Hkv = pk.shape[1]
    G = Hq // Hkv
    scale = D ** -0.5
    qf = q.float()
    qg = qf.reshape(B, K, Hkv, G, D)
    lp = torch.einsum("bkhgd,bhpd->bkhgp", qg, pk.float()) * scale
    lp = lp + torch.where(prefix_mask, 0.0, NEG_INF)[:, None, None, None, :]
    qg2 = qf.reshape(BK, Hkv, G, D)
    lg = (torch.einsum("khgd,khnd->khgn", qg2, gk.float()) * scale).reshape(B, K, Hkv, G, -1)
    lg = lg + torch.where(gen_mask, 0.0, NEG_INF)[None, None, None, None, :]
    lc = torch.einsum("khgd,khd->khg", qg2, k_cur.float()) * scale
    lc = lc.reshape(B, K, Hkv, G)[..., None]
    m = torch.maximum(torch.maximum(lp.amax(dim=-1), lg.amax(dim=-1)), lc[..., 0])[..., None]
    ep, eg, ec = torch.exp(lp - m), torch.exp(lg - m), torch.exp(lc - m)
    denom = ep.sum(dim=-1) + eg.sum(dim=-1) + ec[..., 0]  # (B, K, Hkv, G)
    dt = pv.dtype
    op = torch.einsum("bkhgp,bhpd->bkhgd", ep.to(dt), pv)
    og = torch.einsum("khgn,khnd->khgd", eg.reshape(BK, Hkv, G, -1).to(dt), gv)
    oc = ec.reshape(BK, Hkv, G, 1).to(v_cur.dtype) * v_cur[:, :, None, :]
    out = (op + og.reshape(B, K, Hkv, G, D) + oc.reshape(B, K, Hkv, G, D)) / denom[..., None].to(dt)
    return out.reshape(BK, 1, Hq, D)


def llm_decode_step_beam(
    params: Params,
    cfg: LLMConfig,
    token_embeds: torch.Tensor,  # (B*K, 1, H)
    step: int,
    n_valid: torch.Tensor,  # (B*K,) valid prefix tokens (rope positions)
    prefix_mask: torch.Tensor,  # (B, P) bool
    cache: SplitCache,  # already reordered for this step
    num_beams: int,
    modality: Optional[str] = None,
    layers: Optional[List[Params]] = None,
) -> Tuple[torch.Tensor, SplitCache]:
    """One beam step of the reorder route (`omni_avsr_tpu/models/llm.py:
    751-801`): every layer's attention is `merged_beam_attention` over the
    reordered cache; this step's K/V land in slot `step` after the layer's
    attention. Returns ((B*K, V) f32 logits, cache)."""
    BK = token_embeds.shape[0]
    layers = layers if layers is not None else unstack_layers(params, cfg)
    hq, hkv = local_heads(cfg)
    cos, sin = rope_cos_sin(cfg, (n_valid + step)[:, None])
    N = cache.gen_k.shape[3]
    gen_mask = torch.arange(N, device=token_embeds.device) < step
    x = token_embeds
    for i, layer in enumerate(layers):
        h = rms_norm(x, layer["input_norm"]["scale"], cfg.rms_norm_eps)
        q, k, v = _qkv_with_lora(layer, cfg, h, modality)
        q = q.reshape(BK, 1, hq, cfg.head_dim)
        k = k.reshape(BK, 1, hkv, cfg.head_dim)
        v = v.reshape(BK, 1, hkv, cfg.head_dim)
        q, k = apply_rope(q, k, cos, sin)
        k_cur, v_cur = k[:, 0], v[:, 0]
        out = merged_beam_attention(
            q, cache.prefix_k[i].to(q.dtype), cache.prefix_v[i].to(q.dtype),
            cache.gen_k[:, i].to(q.dtype), cache.gen_v[:, i].to(q.dtype), k_cur, v_cur,
            prefix_mask, gen_mask, num_beams)
        cache.append_(i, k_cur, v_cur, step)
        x = x + _leave(linear(out.reshape(BK, 1, -1), layer["attn"]["o"]), "llm.attn")
        h2 = rms_norm(x, layer["post_attn_norm"]["scale"], cfg.rms_norm_eps)
        x = x + _mlp_block(layer, h2, cfg)
    return lm_head(params, cfg, x)[:, 0], cache


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
    hq, hkv = local_heads(cfg)
    positions = (n_valid + step)[:, None]
    cos, sin = rope_cos_sin(cfg, positions)
    prefix_bias = torch.where(prefix_mask, 0.0, NEG_INF).float()
    x = token_embeds
    for i, layer in enumerate(layers):
        h = rms_norm(x, layer["input_norm"]["scale"], cfg.rms_norm_eps)
        q, k, v = _qkv_with_lora(layer, cfg, h, modality)
        q = q.reshape(BK, 1, hq, cfg.head_dim)
        k = k.reshape(BK, 1, hkv, cfg.head_dim)
        v = v.reshape(BK, 1, hkv, cfg.head_dim)
        q, k = apply_rope(q, k, cos, sin)
        k_cur, v_cur = k[:, 0].contiguous(), v[:, 0].contiguous()
        out = beam_decode_attention(
            q.contiguous(), cache.prefix_k[i].to(q.dtype), cache.prefix_v[i].to(q.dtype),
            cache.gen_k[i].to(q.dtype), cache.gen_v[i].to(q.dtype), k_cur, v_cur,
            prefix_bias, anc, step, num_beams)
        cache.append_(i, k_cur, v_cur, step, num_beams)
        x = x + _leave(linear(out.reshape(BK, 1, -1), layer["attn"]["o"]), "llm.attn")
        h2 = rms_norm(x, layer["post_attn_norm"]["scale"], cfg.rms_norm_eps)
        x = x + _mlp_block(layer, h2, cfg)
    return lm_head(params, cfg, x)[:, 0], cache
