"""Beam search on the ancestor route (port of `beam_search`, `beam_loop` and
`topk_chunked` of `omni_avsr_tpu/decode/decoding.py`).

HF `BeamSearchScorer` semantics, as the JAX package reproduces them
(`modeling_OmniAVSR.py:308-323`, beams 15, 32 new tokens):
  - beam 0 starts at score 0, the others at -1e9;
  - per step the top 2K of the K*V candidates; EOS candidates ranked < K
    become finished hypotheses (score / generated_len ** length_penalty);
    the K best non-EOS candidates run on;
  - at the end the running beams are offered to the hypothesis heap and
    the best normalised hypothesis wins.
Candidate selection is the JAX package's default "fused" route: the exact
per-beam top-2K of the raw logits, then the 2K*K survivors are scored. The
loop stops early once no running beam can beat the worst kept hypothesis,
which leaves the result unchanged. Ties resolve to the lower index, as
`jax.lax.top_k` does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import LLMConfig
from ..models.common import Params
from ..models.llm import (
    AncSplitCache,
    KVCache,
    embed_tokens,
    llm_decode_step_beam_anc,
    llm_prefill_masked,
    unstack_layers,
    update_ancestors,
)

NEG = -1e9


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last axis, sorted descending, ties to the lower
    index (`jax.lax.top_k` order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_chunked(x: torch.Tensor, k: int, chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the last axis through a chunk-max prefilter: the
    top-k chunks by maximum hold every element of the top k, so the finish
    runs over k*chunk survivors (recursing once with chunk 16)."""
    V = x.shape[-1]
    if V <= 4 * k * chunk:
        return top_k(x, k)
    C = -(-V // chunk)
    if C * chunk != V:
        pad = torch.full((*x.shape[:-1], C * chunk - V), NEG, dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad], dim=-1)
    xc = x.reshape(*x.shape[:-1], C, chunk)
    cm = xc.amax(dim=-1)
    kc = min(k, C)
    _, cidx = top_k(cm, kc)
    cand = torch.gather(xc, -2, cidx[..., None].expand(*cidx.shape, chunk))
    flat = cand.reshape(*cand.shape[:-2], kc * chunk)
    if chunk > 64:
        vals, gi = topk_chunked(flat, k, chunk=16)
    else:
        vals, gi = top_k(flat, k)
    idx = torch.gather(cidx, -1, gi // chunk) * chunk + gi % chunk
    return vals, idx


class BeamOutput(NamedTuple):
    tokens: torch.Tensor  # (B, max_new) best hypothesis, pad after it
    steps: int  # decode steps run (each ran every decoder layer once)


def beam_loop(*, init_logits: torch.Tensor, state, step_fn, num_beams: int,
              vocab_size: int, max_new: int, eos_id: int, pad_id: int,
              length_penalty: float = 1.0) -> BeamOutput:
    """Decoder-agnostic beam loop. step_fn(state, new_tok (B,K), flat_idx
    (B*K,), t) -> ((B, K, V) logits, state)."""
    B = init_logits.shape[0]
    K, V = num_beams, vocab_size
    dev = init_logits.device
    logits = init_logits[:, None].expand(B, K, V)
    cum = torch.tensor([0.0] + [NEG] * (K - 1), dtype=torch.float32, device=dev).repeat(B, 1)
    tokens = torch.full((B, K, max_new), pad_id, dtype=torch.long, device=dev)
    h_s = torch.full((B, K), NEG, dtype=torch.float32, device=dev)
    h_t = torch.full((B, K, max_new), pad_id, dtype=torch.long, device=dev)
    h_l = torch.zeros((B, K), dtype=torch.long, device=dev)
    batch_offsets = (torch.arange(B, device=dev) * K)[:, None]

    def insert_hyps(h_s, h_t, h_l, c_s, c_t, c_l):
        s = torch.cat([h_s, c_s], dim=1)
        tks = torch.cat([h_t, c_t], dim=1)
        ls = torch.cat([h_l, c_l], dim=1)
        top = top_k(s, K)[1]
        return (torch.gather(s, 1, top),
                torch.gather(tks, 1, top[:, :, None].expand(B, K, max_new)),
                torch.gather(ls, 1, top))

    def done() -> bool:
        if max_new <= 1 or length_penalty < 0:
            return False
        best_attainable = cum.amax(dim=1) / (float(max_new) ** length_penalty)
        return bool(torch.all(h_s.amin(dim=1) >= best_attainable))

    t = 0
    while t < max_new and not done():
        x = logits.float()
        mx = x.amax(dim=-1, keepdim=True)
        lse = torch.log(torch.exp(x - mx).sum(dim=-1, keepdim=True))
        vals, vidx = topk_chunked(x, 2 * K)  # (B, K, 2K) per beam
        cand_sel = cum[:, :, None] + ((vals - mx) - lse)
        scores2k, sel = top_k(cand_sel.reshape(B, K * 2 * K), 2 * K)
        v_sel = torch.gather(vidx.reshape(B, K * 2 * K), 1, sel)
        idx2k = torch.div(sel, 2 * K, rounding_mode="floor") * V + v_sel
        parent = torch.div(idx2k, V, rounding_mode="floor")
        tok = idx2k % V
        is_eos = tok == eos_id

        rank = torch.arange(2 * K, device=dev)[None].expand(B, 2 * K)
        eligible = is_eos & (rank < K)
        norm = scores2k / (float(max(t, 1)) ** length_penalty)
        cand_scores = torch.where(eligible, norm, torch.full((), NEG, device=dev))
        parent_tokens = torch.gather(tokens, 1, parent[:, :, None].expand(B, 2 * K, max_new))
        cand_lens = torch.full((B, 2 * K), t, dtype=torch.long, device=dev)
        h_s, h_t, h_l = insert_hyps(h_s, h_t, h_l, cand_scores, parent_tokens, cand_lens)

        run_scores = torch.where(is_eos, torch.full((), NEG, device=dev), scores2k)
        top_run = top_k(run_scores, K)[1]
        cum = torch.gather(run_scores, 1, top_run)
        new_parent = torch.gather(parent, 1, top_run)
        new_tok = torch.gather(tok, 1, top_run)
        tokens = torch.gather(tokens, 1, new_parent[:, :, None].expand(B, K, max_new)).clone()
        tokens[:, :, t] = new_tok
        flat_idx = (batch_offsets + new_parent).reshape(-1)
        logits, state = step_fn(state, new_tok, flat_idx, t)
        t += 1

    final_norm = cum / (float(max_new) ** length_penalty)
    h_s, h_t, h_l = insert_hyps(h_s, h_t, h_l, final_norm, tokens,
                                torch.full((B, K), max_new, dtype=torch.long, device=dev))
    best = torch.argmax(h_s, dim=1)
    best_tokens = h_t[torch.arange(B, device=dev), best]
    best_len = h_l[torch.arange(B, device=dev), best]
    mask = torch.arange(max_new, device=dev)[None] < best_len[:, None]
    return BeamOutput(torch.where(mask, best_tokens, torch.full((), pad_id, device=dev)), t)


def beam_search(
    params: Params,
    cfg: LLMConfig,
    prefix_embeds: torch.Tensor,  # (B, P, H)
    *,
    key_valid: torch.Tensor,  # (B, P) bool gap-tolerant validity
    num_beams: int,
    max_new: int,
    eos_id: int,
    pad_id: int,
    modality: Optional[str] = None,
    length_penalty: float = 1.0,
    cache_dtype=torch.bfloat16,
) -> BeamOutput:
    """Prefill once per batch item (the prefix K/V is shared by all beams),
    then run the beam loop on the ancestor cache: no per-step reorder of
    the generated K/V, only of the (B, K, N) ancestor table."""
    B, P, _ = prefix_embeds.shape
    K = num_beams
    V = cfg.vocab_size
    dtype = prefix_embeds.dtype
    dev = prefix_embeds.device
    layers = unstack_layers(params, cfg)

    n_valid = key_valid.sum(dim=1)
    positions = torch.cumsum(key_valid.long(), dim=1) - 1
    rev_arg = torch.argmax(key_valid.flip(1).int(), dim=1)
    last_idx = P - 1 - rev_arg
    cache0 = KVCache.create(cfg, B, P, dtype=cache_dtype, device=dev)
    logits0, cache0 = llm_prefill_masked(params, cfg, prefix_embeds, key_valid, positions,
                                         last_idx, cache0, modality, layers=layers)
    n_valid_bk = n_valid.repeat_interleave(K)
    cache = AncSplitCache.from_prefill(cache0, P, K, max_new)
    anc0 = torch.arange(K, dtype=torch.int32, device=dev)[None, :, None].expand(B, K, max_new)

    def step_fn(state, new_tok, flat_idx, t):
        cache, anc = state
        anc = update_ancestors(anc, flat_idx, t, K)
        emb = embed_tokens(params, new_tok.reshape(B * K, 1), dtype)
        logits, cache = llm_decode_step_beam_anc(
            params, cfg, emb, t, n_valid_bk, key_valid, cache, anc, K, modality,
            layers=layers)
        return logits.reshape(B, K, V), (cache, anc)

    return beam_loop(init_logits=logits0, state=(cache, anc0.contiguous()), step_fn=step_fn,
                     num_beams=K, vocab_size=V, max_new=max_new, eos_id=eos_id,
                     pad_id=pad_id, length_penalty=length_penalty)
