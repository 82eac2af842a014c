"""Greedy decoding and beam search (port of `greedy_decode`, `beam_search`,
`beam_loop`, `ngram_ban_mask` and `topk_chunked` of
`omni_avsr_tpu/decode/decoding.py`).

Two attention routes, the JAX package's two, chosen by `attn_route`
(`decode_route`, the table of `decoding.py:337-348`):
  "kernel": the no-reorder ancestor cache, every step's attention through
    `llm_decode_step_beam_anc` (B1 on the card; a CPU tensor takes B1's
    plain version);
  "xla": the reorder route: the generated K/V are gathered by parent beam
    every step (`SplitCache.reorder_`) and attended with the three-block
    joint softmax in torch ops (`llm_decode_step_beam`), as the JAX package
    computes it with XLA.
`None` takes the kernel route on the card where B1 takes the head size
(64, 128), else the reorder route; on the CPU it keeps the ancestor route.
An explicit "xla" also pins the selection statistics to torch ops. Greedy
decoding is the same machinery with one beam, argmax, `pad_id` after EOS,
and an early exit once every row has emitted EOS (checked per step here,
per 8-step chunk there: the tokens are the same).

The prefix is contiguous (`prefix_len`, `llm_prefill`) or gap-tolerant
(`key_valid`, `llm_prefill_masked`), as `_prefill` dispatches there.

HF `BeamSearchScorer` semantics, as the JAX package reproduces them
(`modeling_OmniAVSR.py:308-323`, beams 15, 32 new tokens):
  - beam 0 starts at score 0, the others at -1e9;
  - per step the top 2K of the K*V candidates; EOS candidates ranked < K
    become finished hypotheses (score / generated_len ** length_penalty);
    the K best non-EOS candidates run on;
  - at the end the running beams are offered to the hypothesis heap and
    the best normalised hypothesis wins.
Candidate selection (`select_mode`): "fused", the JAX package's default,
takes the exact per-beam top-2K of the raw logits, then scores the 2K*K
survivors; "grid" (its `OMNI_BEAM_SELECT=grid`) takes the top 2K of the
whole (B, K*V) grid of log-probabilities, and is forced whenever
`no_repeat_ngram_size > 0`, since the ban mask must land before the
selection (`ngram_ban_mask`, fairseq's `ngram_repeat_block` as window
compares). The loop stops early once no running beam can beat the worst
kept hypothesis, which leaves the result unchanged. Ties resolve to the
lower index, as `jax.lax.top_k` does. With `select_kernel=True` (the JAX
package's `OMNI_SELECT_KERNEL=1`) each fused step's row max, normaliser
and 128-wide chunk maxima come from one pass of the stats kernel B5
(`ops/select_topk.py::row_stats_chunkmax`) instead of three passes.

Under tensor-parallel serving (`serve.py::Transcriber(mesh=...)`) the
lm_head gives each rank its slice of the vocabulary. The fused selection
then runs per vocabulary shard (`_fused_select_sharded`: B5 and the
chunked top-2K on V/tp, then an exact merge over tp); every other
consumer of the logits all-gathers them first (`full_logits`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import LLMConfig
from ..models.common import Params
from ..models.llm import (
    AncSplitCache,
    KVCache,
    SplitCache,
    embed_tokens,
    llm_decode_step_beam,
    llm_decode_step_beam_anc,
    llm_prefill,
    llm_prefill_masked,
    unstack_layers,
    update_ancestors,
)
from ..ops.beam_attention import kernel_supported
from ..ops.select_topk import CHUNK, row_stats_chunkmax, select_stats_supported
from ..parallel import collectives as par
from ..parallel.mesh import Axis, axis

NEG = -1e9
ATTN_ROUTES = (None, "kernel", "xla")
SELECT_MODES = ("fused", "grid")


def decode_route(attn_route: Optional[str], head_dim: int, device) -> str:
    """The attention route a decode takes, "kernel" or "xla": the caller's,
    else the kernel where B1 takes the head size on the card, the reorder
    route where it does not, and the ancestor route on the CPU
    (`omni_avsr_tpu/decode/decoding.py:337-348`). An explicit "kernel" on
    the card launches B1 or raises; it never falls back."""
    if attn_route not in ATTN_ROUTES:
        raise ValueError(f"attn_route {attn_route!r}: one of {ATTN_ROUTES}")
    if attn_route is not None:
        return attn_route
    if torch.device(device).type == "cuda" and not kernel_supported(head_dim):
        return "xla"
    return "kernel"


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last axis, sorted descending, ties to the lower
    index (`jax.lax.top_k` order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_chunked(x: torch.Tensor, k: int, chunk: int = 128,
                 chunk_maxima: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the last axis through a chunk-max prefilter: the
    top-k chunks by maximum hold every element of the top k, so the finish
    runs over k*chunk survivors (recursing once with chunk 16).
    `chunk_maxima` are precomputed maxima of this (chunk, V) split (from
    B5), which needs V % chunk == 0; given them, short rows take the
    prefilter too."""
    V = x.shape[-1]
    if chunk_maxima is None and V <= 4 * k * chunk:
        return top_k(x, k)
    C = -(-V // chunk)
    if C * chunk != V:
        if chunk_maxima is not None:
            raise ValueError(f"chunk_maxima needs V % chunk == 0 (V {V}, chunk {chunk})")
        pad = torch.full((*x.shape[:-1], C * chunk - V), NEG, dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad], dim=-1)
    xc = x.reshape(*x.shape[:-1], C, chunk)
    cm = chunk_maxima if chunk_maxima is not None else xc.amax(dim=-1)
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


def select_kernel_supported(vocab_size: int) -> bool:
    """The vocabularies the JAX package's `OMNI_SELECT_KERNEL=1` routes to
    the stats kernel (`decode/decoding.py:431-434`): at least 16384 and
    `select_stats_supported`."""
    return vocab_size >= 16384 and select_stats_supported(vocab_size)


def full_logits(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """The logits over the whole vocabulary: a tensor-parallel head's
    slices all-gathered over tp."""
    if logits.shape[-1] == vocab_size:
        return logits
    return par.all_gather(logits, par.tp_axis("llm.lm_head"), -1)


def select_shard(x: torch.Tensor, k2: int, use_kernel: bool, offset: int = 0):
    """One vocabulary shard's part of the fused selection: x (B, K, Vs),
    the columns [offset, offset + Vs) of the logits. Returns its row maxima
    and normalisers (B, K) and its per-beam top-k2 values with their
    global indices (B, K, k2), through B5 and the chunked top-k with
    `use_kernel`, else torch ops. B5 takes whole 128-wide chunks: a shard
    that is no multiple of 128 (Llama-3's 128256 at tp 4) is padded with
    -inf columns, which change no maximum and add 0 to the normaliser, and
    which no top-k2 of a row with k2 finite values selects."""
    B, K, Vs = x.shape
    if use_kernel:
        if Vs % CHUNK:
            pad = x.new_full((B, K, CHUNK - Vs % CHUNK), float("-inf"))
            x = torch.cat([x, pad], dim=-1)
        cm, mx_s, se_s = row_stats_chunkmax(x.reshape(B * K, x.shape[-1]))
        mx_s, se_s = mx_s.reshape(B, K), se_s.reshape(B, K)
        vals_s, vidx_s = topk_chunked(x, k2, chunk_maxima=cm.reshape(B, K, -1))
    else:
        mx_s = x.amax(dim=-1)
        se_s = torch.exp(x - mx_s[..., None]).sum(dim=-1)
        vals_s, vidx_s = topk_chunked(x, k2)
    return mx_s, se_s, vals_s, vidx_s + offset


def merge_select_shards(mx_s: torch.Tensor, se_s: torch.Tensor, vals_s: torch.Tensor,
                        gidx_s: torch.Tensor, k2: int):
    """The exact merge of the shards' `select_shard` results, stacked on a
    trailing axis in shard order: mx_s, se_s (B, K, tp), vals_s, gidx_s
    (B, K, tp * k2). The row maximum is the shards' maximum, the normaliser
    the sum of se_s * exp(mx_s - mx) in shard order, and one top-k over the
    tp x k2 candidates keeps k2 (every global winner wins its own shard).
    Returns (mx, lse) (B, K, 1) and the values and global indices (B, K, k2)."""
    mx = mx_s.amax(dim=-1, keepdim=True)
    se = (se_s * torch.exp(mx_s - mx)).sum(dim=-1, keepdim=True)
    vals, sel = top_k(vals_s, k2)
    return mx, torch.log(se), vals, torch.gather(gidx_s, -1, sel)


def _fused_select_sharded(x: torch.Tensor, k2: int, tp: Axis, use_kernel: bool):
    """Vocabulary-sharded fused selection (`omni_avsr_tpu/decode/decoding.py:
    112-168`). x: (B, K, V/tp), this rank's slice. Each rank runs
    `select_shard` on its slice; the (B, K) maxima and normalisers and the
    tp x k2 candidates are all-gathered over tp and merged exactly by
    `merge_select_shards`, the same on every rank. Gathering the (B, K)
    statistics in place of the JAX package's pmax / psum costs tp x B x K
    floats and fixes the normaliser's summation order.
    Returns (mx, lse, vals, vidx)."""
    mx_s, se_s, vals_s, gidx_s = select_shard(x, k2, use_kernel, tp.rank * x.shape[-1])
    return merge_select_shards(par.all_gather(mx_s[..., None], tp, 2),
                               par.all_gather(se_s[..., None], tp, 2),
                               par.all_gather(vals_s, tp, 2), par.all_gather(gidx_s, tp, 2), k2)


class DecodeOutput(NamedTuple):
    tokens: torch.Tensor  # (B, max_new) generated ids (beam: the best hypothesis), pad after
    steps: int  # decode steps run (each ran every decoder layer once)


def ngram_ban_mask(tokens: torch.Tensor, t: int, n: int, vocab_size: int) -> torch.Tensor:
    """(B, K, V) additive mask that bans every token which would complete an
    n-gram the beam has already generated: the (n-1)-token suffix ending
    at slot t-1 compared with every window of the token buffer at once,
    then one scatter-add of -1e9 at each hit's next token
    (`omni_avsr_tpu/decode/decoding.py:458-484`)."""
    B, K, max_new = tokens.shape
    dev = tokens.device
    nm1 = n - 1
    W = max_new - nm1
    suf_idx = torch.clamp(t - nm1 + torch.arange(nm1, device=dev), 0, max_new - 1)
    suffix = tokens[:, :, suf_idx]  # (B, K, nm1)
    win_idx = torch.arange(W, device=dev)[:, None] + torch.arange(nm1, device=dev)[None, :]
    windows = tokens[:, :, win_idx]  # (B, K, W, nm1)
    j = torch.arange(W, device=dev)
    targets = tokens[:, :, j + nm1]  # (B, K, W)
    hit = (torch.all(windows == suffix[:, :, None, :], dim=-1)
           & ((j + nm1)[None, None] <= t - 1) & (t >= nm1))
    vals = torch.where(hit, NEG, 0.0)
    ban = torch.zeros((B, K, vocab_size), dtype=torch.float32, device=dev)
    return ban.scatter_add_(2, targets, vals)


def beam_loop(*, init_logits: torch.Tensor, state, step_fn, num_beams: int,
              vocab_size: int, max_new: int, eos_id: int, pad_id: int,
              length_penalty: float = 1.0, select_kernel: bool = False,
              no_repeat_ngram_size: int = 0, select_mode: str = "fused",
              select_mesh=None) -> DecodeOutput:
    """Decoder-agnostic beam loop. step_fn(state, new_tok (B,K), flat_idx
    (B*K,), t) -> ((B, K, V) logits, state). `select_kernel` takes each
    fused step's selection statistics from B5 (V % 128 == 0);
    `select_mode="grid"`, or a positive `no_repeat_ngram_size`, selects on
    the full candidate grid. With `select_mesh` (a tp mesh) the fused
    selection runs per vocabulary shard (`_fused_select_sharded`), unless
    there is nothing to shard, V does not divide tp or 2K > V/tp, as the
    JAX guard (`decoding.py:412-420`); the logits may then be this rank's
    vocabulary slice (a tensor-parallel lm_head) or the whole of it."""
    if select_mode not in SELECT_MODES:
        raise ValueError(f"select_mode {select_mode!r}: one of {SELECT_MODES}")
    grid = no_repeat_ngram_size > 0 or select_mode == "grid"
    B = init_logits.shape[0]
    K, V = num_beams, vocab_size
    dev = init_logits.device
    tp = axis(select_mesh, "tp") if select_mesh is not None else None
    if tp is not None and (tp.size <= 1 or V % tp.size or 2 * K > V // tp.size or grid):
        tp = None  # nothing to shard (or V not divisible): the local route
    logits = init_logits[:, None].expand(B, K, init_logits.shape[-1])
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
        if tp is not None:
            if x.shape[-1] == V:  # a replicated head: this rank's slice
                x = x[..., tp.rank * (V // tp.size):(tp.rank + 1) * (V // tp.size)]
            mx, lse, vals, vidx = _fused_select_sharded(x, 2 * K, tp, select_kernel)
            cand_sel = cum[:, :, None] + ((vals - mx) - lse)
            scores2k, sel = top_k(cand_sel.reshape(B, K * 2 * K), 2 * K)
            v_sel = torch.gather(vidx.reshape(B, K * 2 * K), 1, sel)
            idx2k = torch.div(sel, 2 * K, rounding_mode="floor") * V + v_sel
        elif grid:
            x = full_logits(x, V)  # the (B, K*V) grid of log-probabilities (`decoding.py:486-495`)
            shifted = x - x.amax(dim=-1, keepdim=True)
            logp = shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))
            if no_repeat_ngram_size > 0:
                logp = logp + ngram_ban_mask(tokens, t, no_repeat_ngram_size, V)
            scores2k, idx2k = top_k((cum[:, :, None] + logp).reshape(B, K * V), 2 * K)
        else:
            x = full_logits(x, V)
            if select_kernel:  # one pass: chunk maxima, row max, normaliser (`:510-523`)
                cm, mx, se = row_stats_chunkmax(x.reshape(B * K, V))
                mx = mx.reshape(B, K, 1)
                lse = torch.log(se).reshape(B, K, 1)
                vals, vidx = topk_chunked(x, 2 * K, chunk_maxima=cm.reshape(B, K, -1))
            else:
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
    return DecodeOutput(torch.where(mask, best_tokens, torch.full((), pad_id, device=dev)), t)


def _prefill(params: Params, cfg: LLMConfig, prefix_embeds: torch.Tensor,
             prefix_len: Optional[torch.Tensor], key_valid: Optional[torch.Tensor],
             modality: Optional[str], cache_dtype, layers):
    """The prefill of the (B, P) prefix, contiguous (`prefix_len`) or
    gap-tolerant (`key_valid`) (`omni_avsr_tpu/decode/decoding.py:170-187`):
    the (B, V) logits at each row's last valid slot, the prefill cache, the
    (B,) number of valid prefix tokens (the rope position of the first
    generated token) and the (B, P) mask of valid prefix slots."""
    if (prefix_len is None) == (key_valid is None):
        raise ValueError("decode needs prefix_len (contiguous prefix) or key_valid "
                         "(gap-tolerant), one of them")
    B, P, _ = prefix_embeds.shape
    dev = prefix_embeds.device
    cache0 = KVCache.create(cfg, B, P, dtype=cache_dtype, device=dev)
    if key_valid is None:
        prefix_len = prefix_len.to(dev)
        logits0, cache0 = llm_prefill(params, cfg, prefix_embeds, prefix_len, cache0, modality,
                                      layers=layers)
        return logits0, cache0, prefix_len, torch.arange(P, device=dev)[None] < prefix_len[:, None]
    n_valid = key_valid.sum(dim=1)
    positions = torch.cumsum(key_valid.long(), dim=1) - 1
    last_idx = P - 1 - torch.argmax(key_valid.flip(1).int(), dim=1)
    logits0, cache0 = llm_prefill_masked(params, cfg, prefix_embeds, key_valid, positions,
                                         last_idx, cache0, modality, layers=layers)
    return logits0, cache0, n_valid, key_valid


def greedy_decode(
    params: Params,
    cfg: LLMConfig,
    prefix_embeds: torch.Tensor,  # (B, P, H)
    prefix_len: Optional[torch.Tensor] = None,  # (B,) contiguous-prefix lengths
    *,
    max_new: int,
    eos_id: int,
    pad_id: int,
    modality: Optional[str] = None,
    key_valid: Optional[torch.Tensor] = None,  # (B, P) bool gap-tolerant validity
    cache_dtype=torch.bfloat16,
    attn_route: Optional[str] = None,
) -> DecodeOutput:
    """(B, max_new) argmax ids, `pad_id` after each row's EOS (the EOS
    itself is kept). The decode step of the last token is not run: its
    logits would pick nothing. `attn_route` as `decode_route`."""
    B, P, _ = prefix_embeds.shape
    dev = prefix_embeds.device
    route = decode_route(attn_route, cfg.head_dim, dev)
    layers = unstack_layers(params, cfg)
    logits, cache0, n_valid, prefix_mask = _prefill(params, cfg, prefix_embeds, prefix_len,
                                                    key_valid, modality, cache_dtype, layers)
    if route == "kernel":
        cache = AncSplitCache.from_prefill(cache0, P, 1, max_new)
        anc = torch.zeros((B, 1, max_new), dtype=torch.int32, device=dev)  # K = 1: row 0 always

        def decode_step(emb, t):
            return llm_decode_step_beam_anc(params, cfg, emb, t, n_valid, prefix_mask, cache,
                                            anc, 1, modality, layers=layers)[0]
    else:
        cache = SplitCache.from_prefill(cache0, P, 1, max_new)

        def decode_step(emb, t):  # K = 1: no parents, no reorder
            return llm_decode_step_beam(params, cfg, emb, t, n_valid, prefix_mask, cache, 1,
                                        modality, layers=layers)[0]
    del cache0
    tokens = torch.full((B, max_new), pad_id, dtype=torch.long, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    steps = 0
    for t in range(max_new):
        tok = torch.argmax(full_logits(logits, cfg.vocab_size), dim=-1)
        tok = torch.where(done, torch.full_like(tok, pad_id), tok)
        done = done | (tok == eos_id)
        tokens[:, t] = tok
        if t == max_new - 1 or bool(done.all()):
            break
        logits = decode_step(embed_tokens(params, tok[:, None], prefix_embeds.dtype), t)
        steps += 1
    return DecodeOutput(tokens, steps)


def beam_search(
    params: Params,
    cfg: LLMConfig,
    prefix_embeds: torch.Tensor,  # (B, P, H)
    prefix_len: Optional[torch.Tensor] = None,  # (B,) contiguous-prefix lengths
    *,
    num_beams: int,
    max_new: int,
    eos_id: int,
    pad_id: int,
    modality: Optional[str] = None,
    length_penalty: float = 1.0,
    no_repeat_ngram_size: int = 0,
    key_valid: Optional[torch.Tensor] = None,  # (B, P) bool gap-tolerant validity
    cache_dtype=torch.bfloat16,
    select_kernel: bool = False,
    attn_route: Optional[str] = None,
    select_mode: str = "fused",
    attn_mesh=None,
) -> DecodeOutput:
    """Prefill once per batch item (the prefix K/V is shared by all beams),
    then the beam loop on the route `decode_route` picks: the ancestor
    cache (no per-step reorder of the generated K/V, only of the (B, K, N)
    ancestor table) or the reorder route. `select_kernel` takes the
    selection statistics from B5; it needs a vocabulary that the JAX
    package's opt-in takes the kernel for (`select_kernel_supported`), else
    it raises; an explicit `attn_route="xla"` turns it off, as there.
    `no_repeat_ngram_size > 0` bans repeated n-grams (on the grid).
    `attn_mesh`, a tp mesh whose heads B1 shards, also shards the fused
    selection over the vocabulary (`beam_loop(select_mesh=...)`), as the
    JAX package passes its `attn_mesh` on; B5 then runs on each rank's
    shard (`select_shard`)."""
    B, P, _ = prefix_embeds.shape
    K = num_beams
    V = cfg.vocab_size
    dev = prefix_embeds.device
    route = decode_route(attn_route, cfg.head_dim, dev)
    if attn_route == "xla":
        select_kernel = False
    if select_kernel and not select_kernel_supported(V):
        raise ValueError(f"select_kernel: vocabulary {V} is not supported by the selection "
                         f"stats kernel (needs V % {CHUNK} == 0 and 16384 <= V <= 212992)")
    dtype = prefix_embeds.dtype
    layers = unstack_layers(params, cfg)
    logits0, cache0, n_valid, prefix_mask = _prefill(params, cfg, prefix_embeds, prefix_len,
                                                     key_valid, modality, cache_dtype, layers)
    n_valid_bk = n_valid.repeat_interleave(K)
    if route == "kernel":
        cache = AncSplitCache.from_prefill(cache0, P, K, max_new)
        anc0 = torch.arange(K, dtype=torch.int32, device=dev)[None, :, None].expand(B, K, max_new)
        state0 = (cache, anc0.contiguous())

        def step_fn(state, new_tok, flat_idx, t):
            cache, anc = state
            anc = update_ancestors(anc, flat_idx, t, K)
            emb = embed_tokens(params, new_tok.reshape(B * K, 1), dtype)
            logits, cache = llm_decode_step_beam_anc(
                params, cfg, emb, t, n_valid_bk, prefix_mask, cache, anc, K, modality,
                layers=layers)
            return logits.reshape(B, K, -1), (cache, anc)
    else:
        state0 = SplitCache.from_prefill(cache0, P, K, max_new)

        def step_fn(cache, new_tok, flat_idx, t):
            cache = cache.reorder_(flat_idx)
            emb = embed_tokens(params, new_tok.reshape(B * K, 1), dtype)
            logits, cache = llm_decode_step_beam(params, cfg, emb, t, n_valid_bk, prefix_mask,
                                                 cache, K, modality, layers=layers)
            return logits.reshape(B, K, -1), cache
    del cache0

    return beam_loop(init_logits=logits0, state=state0, step_fn=step_fn, num_beams=K,
                     vocab_size=V, max_new=max_new, eos_id=eos_id, pad_id=pad_id,
                     length_penalty=length_penalty, select_kernel=select_kernel,
                     no_repeat_ngram_size=no_repeat_ngram_size, select_mode=select_mode,
                     select_mesh=attn_mesh if route == "kernel" else None)
