"""AV-HuBERT fine-tuning heads: CTC and encoder-decoder (seq2seq) AVSR
(port of `omni_avsr_tpu/models/avhubert_s2s.py`; reference
`av_hubert/avhubert/hubert_asr.py:37-521`, `decoder.py:38-243`):

  CTC:     encoder output -> Linear(D -> V); CTC loss, the plain mean of the
           per-sequence negative log-likelihoods.
  Seq2seq: fairseq's transformer decoder: token embedding (unscaled by
           default) + sinusoidal positions (fairseq's padding-offset
           numbering), post-LN layers of causal self-attention,
           cross-attention over the AV-HuBERT encoder output and a ReLU
           FFN; the output projection shares the input embedding.

Decoding is incremental: the cross-attention K/V are computed once from
the encoder output, the self-attention K/V go into a cache of
`max_new + 1` slots. Beam search keeps ONE copy of the cross K/V per
sample: the K beams of a sample ride the query-time axis of its
cross-attention, (B, K, H, hd) queries against a (B, S, H, hd) K/V, so
the encoder K/V is never copied per beam (`:238-302`). The decoder's head
size is 768 / 4 = 192, where the JAX package takes its plain
`dot_product_attention`; so does the port (no kernel here). Greedy
decoding runs on the host, one sync per step to stop once every row has
emitted EOS (the JAX `while_loop`'s exit), with `pad_id` after EOS.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..decode.decoding import DecodeOutput, beam_loop
from ..ops.attention import causal_mask, dot_product_attention, padding_mask_from_lengths
from ..ops.norms import layer_norm
from .common import Params, layer_slice, linear


@dataclass(frozen=True)
class S2SDecoderConfig:
    vocab_size: int = 1000
    pad_id: int = 1  # fairseq dictionary convention
    eos_id: int = 2
    embed_dim: int = 768
    ffn_dim: int = 3072
    layers: int = 6
    heads: int = 4
    encoder_dim: int = 1024
    normalize_before: bool = False
    share_input_output_embed: bool = True
    activation: str = "relu"
    max_target_positions: int = 2048
    scale_embedding: bool = False  # no_scale_embedding=True default (`hubert.py:316`)


def sinusoidal_embedding(num_pos: int, dim: int, padding_idx: Optional[int]) -> np.ndarray:
    """fairseq SinusoidalPositionalEmbedding.get_embedding, in float64 and
    cast to float32; the padding row zeroed."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    emb = np.exp(np.arange(half, dtype=np.float64) * -emb)
    emb = np.arange(num_pos, dtype=np.float64)[:, None] * emb[None, :]
    emb = np.concatenate([np.sin(emb), np.cos(emb)], axis=1)
    if dim % 2 == 1:
        emb = np.concatenate([emb, np.zeros((num_pos, 1))], axis=1)
    if padding_idx is not None:
        emb[padding_idx, :] = 0
    return emb.astype(np.float32)


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    return F.relu(x) if name == "relu" else F.gelu(x)


def _mha(p: Params, xq: torch.Tensor, xkv: torch.Tensor, heads: int,
         mask: Optional[torch.Tensor]) -> torch.Tensor:
    B, T, _ = xq.shape
    S = xkv.shape[1]
    D = p["q"]["w"].shape[1]
    hd = D // heads
    q = linear(xq, p["q"]).reshape(B, T, heads, hd)
    k = linear(xkv, p["k"]).reshape(B, S, heads, hd)
    v = linear(xkv, p["v"]).reshape(B, S, heads, hd)
    out = dot_product_attention(q, k, v, mask=mask)
    return linear(out.reshape(B, T, D), p["o"])


def _ffn_and_norms(layer: Params, cfg: S2SDecoderConfig, x: torch.Tensor) -> torch.Tensor:
    x = layer_norm(x, layer["cross_norm"]["scale"], layer["cross_norm"]["bias"])
    x = x + linear(_act(linear(x, layer["fc1"]), cfg.activation), layer["fc2"])
    return layer_norm(x, layer["final_norm"]["scale"], layer["final_norm"]["bias"])


def _decoder_layer(layer: Params, cfg: S2SDecoderConfig, x: torch.Tensor, enc: torch.Tensor,
                   self_mask: Optional[torch.Tensor],
                   cross_mask: Optional[torch.Tensor]) -> torch.Tensor:
    # post-LN (decoder_normalize_before defaults False)
    x = x + _mha(layer["self_attn"], x, x, cfg.heads, self_mask)
    x = layer_norm(x, layer["self_norm"]["scale"], layer["self_norm"]["bias"])
    x = x + _mha(layer["cross_attn"], x, enc, cfg.heads, cross_mask)
    return _ffn_and_norms(layer, cfg, x)


def _output_logits(params: Params, cfg: S2SDecoderConfig, x: torch.Tensor) -> torch.Tensor:
    """x (..., D) -> f32 logits: the products of x's dtype accumulated in
    f32 (`preferred_element_type=f32`)."""
    if cfg.share_input_output_embed:
        w = params["embed"]["w"].to(x.dtype).T
    else:
        w = params["embed_out"]["w"].to(x.dtype)
    return torch.matmul(x.float(), w.float())


def _embed(params: Params, cfg: S2SDecoderConfig, tokens: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    scale = math.sqrt(cfg.embed_dim) if cfg.scale_embedding else 1.0
    x = params["embed"]["w"][tokens] * scale
    return x + params["pos"][positions].to(x.dtype)


def s2s_decoder_forward(params: Params, cfg: S2SDecoderConfig, prev_tokens: torch.Tensor,
                        enc_out: torch.Tensor,
                        enc_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Teacher-forced (B, T) inputs over the (B, S, De) encoder output ->
    (B, T, V) f32 logits. fairseq position numbering: a pad token takes
    position `pad_id`, a real token `pad_id` + its running count."""
    B, T = prev_tokens.shape
    not_pad = prev_tokens != cfg.pad_id
    pos = torch.where(not_pad, torch.cumsum(not_pad.long(), dim=1) + cfg.pad_id,
                      torch.full_like(prev_tokens, cfg.pad_id)).long()
    x = _embed(params, cfg, prev_tokens.long(), pos)
    S = enc_out.shape[1]
    self_mask = causal_mask(T, T, x.device).expand(B, 1, T, T)
    cross_mask = None
    if enc_lens is not None:
        cross_mask = padding_mask_from_lengths(enc_lens, S)[:, None, None, :]
    for i in range(cfg.layers):
        x = _decoder_layer(layer_slice(params["layers"], i), cfg, x, enc_out, self_mask,
                           cross_mask)
    return _output_logits(params, cfg, x)


def s2s_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, pad_id: int,
                      label_smoothing: float = 0.1) -> torch.Tensor:
    """Label-smoothed CE over non-pad targets (fairseq's criterion default):
    (1 - eps) nll + eps mean(-logp), averaged over the non-pad tokens."""
    valid = targets != pad_id
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    smooth = -logp.mean(dim=-1)
    loss = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return torch.where(valid, loss, torch.zeros_like(loss)).sum() / valid.sum().clamp(min=1)


# ---------------------------------------------------------------------------
# CTC head
# ---------------------------------------------------------------------------


def ctc_logits(params: Params, enc_out: torch.Tensor) -> torch.Tensor:
    return linear(enc_out, params["proj"]).float()


def ctc_loss(params: Params, enc_out: torch.Tensor, enc_lens: torch.Tensor,
             targets: torch.Tensor, target_lens: torch.Tensor,
             blank_id: int = 0) -> torch.Tensor:
    """The mean over the batch of each sequence's CTC negative
    log-likelihood (optax.ctc_loss on the logits, then `jnp.mean`: not
    divided by the target length). An alignment that cannot be made gives
    inf here where optax gives a large finite value."""
    logp = torch.log_softmax(ctc_logits(params, enc_out), dim=-1)
    per_seq = F.ctc_loss(logp.transpose(0, 1), targets.long(), enc_lens.long(),
                         target_lens.long(), blank=blank_id, reduction="none")
    return per_seq.mean()


# ---------------------------------------------------------------------------
# Incremental decoding: cross K/V computed once, self-attention K/V cached
# ---------------------------------------------------------------------------


def s2s_precompute_cross(params: Params, cfg: S2SDecoderConfig, enc_out: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each layer's cross-attention K/V from the encoder output: two
    (L, B, S, H, hd) tensors."""
    B, S, _ = enc_out.shape
    H = cfg.heads
    hd = cfg.embed_dim // H
    ks, vs = [], []
    for i in range(cfg.layers):
        ca = layer_slice(params["layers"]["cross_attn"], i)
        ks.append(linear(enc_out, ca["k"]).reshape(B, S, H, hd))
        vs.append(linear(enc_out, ca["v"]).reshape(B, S, H, hd))
    return torch.stack(ks), torch.stack(vs)


def _s2s_decode_step(params: Params, cfg: S2SDecoderConfig, tok: torch.Tensor, t: int,
                     self_k: torch.Tensor, self_v: torch.Tensor, cross_k: torch.Tensor,
                     cross_v: torch.Tensor, cross_mask: Optional[torch.Tensor],
                     beams: int = 1, layers: Optional[List[Params]] = None):
    """One incremental step of the (B,) tokens at position t: (f32 (B, V)
    logits, self_k, self_v), the caches (L, B, N, H, hd) written at slot t
    in place. With `beams` > 1, B = samples x beams while the cross K/V
    (L, B / beams, S, H, hd) hold one copy per sample, which every beam of
    the sample attends. `layers` are the decoder's per-layer slices."""
    B = tok.shape[0]
    H = cfg.heads
    D = cfg.embed_dim
    hd = D // H
    pos = torch.full((B,), cfg.pad_id + 1 + t, dtype=torch.long, device=tok.device)
    x = _embed(params, cfg, tok.long(), pos)[:, None]  # (B, 1, D)
    x = x.to(self_k.dtype)
    N = self_k.shape[2]
    self_mask = (torch.arange(N, device=tok.device) <= t)[None, None, None, :]
    if layers is None:
        layers = [layer_slice(params["layers"], i) for i in range(cfg.layers)]
    for i, layer in enumerate(layers):
        sa = layer["self_attn"]
        q = linear(x, sa["q"]).reshape(B, 1, H, hd)
        self_k[i, :, t] = linear(x, sa["k"]).reshape(B, H, hd)
        self_v[i, :, t] = linear(x, sa["v"]).reshape(B, H, hd)
        out = dot_product_attention(q, self_k[i], self_v[i], mask=self_mask)
        x = x + linear(out.reshape(B, 1, D), sa["o"])
        x = layer_norm(x, layer["self_norm"]["scale"], layer["self_norm"]["bias"])
        ca = layer["cross_attn"]
        # beams > 1: the beam axis folded into the query-time axis, (B/K, K,
        # H, hd) queries against the sample's one (B/K, S, H, hd) K/V
        q = linear(x, ca["q"]).reshape(B // beams, beams, H, hd)
        out = dot_product_attention(q, cross_k[i], cross_v[i], mask=cross_mask)
        x = x + linear(out.reshape(B, 1, D), ca["o"])
        x = _ffn_and_norms(layer, cfg, x)
    return _output_logits(params, cfg, x[:, 0]), self_k, self_v


def _decode_setup(params: Params, cfg: S2SDecoderConfig, enc_out: torch.Tensor,
                  enc_lens: Optional[torch.Tensor], max_new: int):
    """(cross K, cross V, cross mask, empty self K/V caches, layer slices)."""
    B, S, _ = enc_out.shape
    H = cfg.heads
    cross_k, cross_v = s2s_precompute_cross(params, cfg, enc_out)
    cross_mask = (padding_mask_from_lengths(enc_lens, S)[:, None, None, :]
                  if enc_lens is not None else None)
    self_k = torch.zeros((cfg.layers, B, max_new + 1, H, cfg.embed_dim // H),
                         dtype=enc_out.dtype, device=enc_out.device)
    layers = [layer_slice(params["layers"], i) for i in range(cfg.layers)]
    return cross_k, cross_v, cross_mask, self_k, torch.zeros_like(self_k), layers


def s2s_beam_decode(params: Params, cfg: S2SDecoderConfig, enc_out: torch.Tensor,
                    enc_lens: Optional[torch.Tensor], max_new: int, num_beams: int,
                    length_penalty: float = 1.0, bos_id: Optional[int] = None) -> DecodeOutput:
    """Beam search over the decoder on the port's HF-semantics beam core
    (`decode/decoding.py::beam_loop`), the replacement for fairseq's
    SequenceGenerator: the first step from `bos` (EOS, as fairseq starts)
    at position `pad_id + 1`, then K beams per sample over one copy of the
    cross K/V each. -> (B, max_new) ids of the best hypothesis, pad after."""
    B = enc_out.shape[0]
    K = num_beams
    bos = cfg.eos_id if bos_id is None else bos_id
    cross_k, cross_v, cross_mask, self_k, self_v, layers = _decode_setup(
        params, cfg, enc_out, enc_lens, max_new)
    tok0 = torch.full((B,), bos, dtype=torch.long, device=enc_out.device)
    logits0, self_k, self_v = _s2s_decode_step(params, cfg, tok0, 0, self_k, self_v, cross_k,
                                               cross_v, cross_mask, layers=layers)
    # only the self-attention cache is tiled per beam
    sk = self_k.repeat_interleave(K, dim=1)
    sv = self_v.repeat_interleave(K, dim=1)

    def step_fn(state, new_tok, flat_idx, t):
        sk, sv = state
        sk, sv = sk[:, flat_idx], sv[:, flat_idx]
        logits, sk, sv = _s2s_decode_step(params, cfg, new_tok.reshape(B * K), t + 1, sk, sv,
                                          cross_k, cross_v, cross_mask, beams=K, layers=layers)
        return logits.reshape(B, K, cfg.vocab_size), (sk, sv)

    return beam_loop(init_logits=logits0, state=(sk, sv), step_fn=step_fn, num_beams=K,
                     vocab_size=cfg.vocab_size, max_new=max_new, eos_id=cfg.eos_id,
                     pad_id=cfg.pad_id, length_penalty=length_penalty)


def s2s_greedy_decode(params: Params, cfg: S2SDecoderConfig, enc_out: torch.Tensor,
                      enc_lens: Optional[torch.Tensor], max_new: int,
                      bos_id: Optional[int] = None) -> DecodeOutput:
    """KV-cached greedy decoding from `bos` (EOS, as fairseq starts):
    (B, max_new) ids, EOS included and `pad_id` after it; stops once every
    row has emitted EOS (one host sync per step)."""
    B = enc_out.shape[0]
    dev = enc_out.device
    bos = cfg.eos_id if bos_id is None else bos_id
    cross_k, cross_v, cross_mask, self_k, self_v, layers = _decode_setup(
        params, cfg, enc_out, enc_lens, max_new)
    tokens = torch.full((B, max_new), cfg.pad_id, dtype=torch.long, device=dev)
    cur = torch.full((B,), bos, dtype=torch.long, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    t = 0
    while t < max_new:
        logits, self_k, self_v = _s2s_decode_step(params, cfg, cur, t, self_k, self_v, cross_k,
                                                  cross_v, cross_mask, layers=layers)
        nxt = torch.where(done, torch.full_like(cur, cfg.pad_id), torch.argmax(logits, dim=-1))
        done = done | (nxt == cfg.eos_id)
        tokens[:, t] = nxt
        cur = nxt
        t += 1
        if bool(done.all()):
            break
    return DecodeOutput(tokens, t)
