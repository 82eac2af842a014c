"""GQA dot-product attention with an f32 softmax: plain torch math, the port
of the XLA route of `omni_avsr_tpu/ops/attention.py`. The group dim is
folded into the einsum, so K/V are never repeated per q-head.

`FLASH_MIN_T_TRAIN` is the sequence length from which the training paths
(AV-HuBERT's encoder, the LLM's causal stack) take the trainable flash
kernels (B3 + B4) on the card instead of this route."""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.collectives import draw_rows
from ..utils import prng

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

# `omni_avsr_tpu/ops/attention.py:33` (its default; the JAX package reads
# an override from the environment for experiments, the port does not)
FLASH_MIN_T_TRAIN = 256


def dot_product_attention(
    q: torch.Tensor,  # (B, T, Hq, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,  # (B, S, Hkv, D)
    mask: Optional[torch.Tensor] = None,  # bool (B, 1|Hq, T, S), True = attend; or additive
    dropout_rate: float = 0.0,
    generator=None,  # a torch.Generator, or a threefry key (utils/prng.py)
) -> torch.Tensor:
    """Returns (B, T, Hq, D). Logits and softmax in f32; probabilities are
    cast to q's dtype before the value contraction, as in the JAX route.
    With a generator and a positive rate, the probabilities are dropped
    with a Bernoulli mask drawn from it and the kept ones scaled by
    1 / (1 - rate) (`omni_avsr_tpu/ops/attention.py:94-96`); a threefry key
    draws JAX's mask, `bernoulli(key, 1 - rate, probs.shape)`."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    qg = q.reshape(B, T, Hkv, G, D)
    logits = torch.einsum("bthgd,bshd->bhgts", qg.float(), k.float()) * scale
    if mask is not None:
        mh = mask.shape[1]
        m = mask[:, :, None] if mh == 1 else mask.reshape(B, Hkv, G, T, -1)
        if mask.dtype == torch.bool:
            logits = torch.where(m, logits, torch.full((), NEG_INF, device=logits.device))
        else:
            logits = logits + m.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if generator is not None and dropout_rate > 0.0:
        if isinstance(generator, torch.Tensor):
            keep = draw_rows(lambda sh: prng.bernoulli(generator, 1.0 - dropout_rate, sh,
                                                       probs.device), probs.shape)
        else:
            keep = draw_rows(lambda sh: torch.rand(sh, generator=generator,
                                                   device=generator.device), probs.shape)
            keep = keep.to(probs.device) < 1.0 - dropout_rate
        probs = probs * keep.to(probs.dtype) / (1.0 - dropout_rate)
    out = torch.einsum("bhgts,bshd->bthgd", probs, v)
    return out.reshape(B, T, Hq, D)


def combine_masks(*masks: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The logical and of the masks given (None ones skipped); None when
    none is given."""
    out = None
    for m in masks:
        if m is not None:
            out = m if out is None else torch.logical_and(out, m)
    return out


def causal_mask(T: int, S: int, device=None) -> torch.Tensor:
    """(1, 1, T, S) bool: query i sees keys <= i."""
    qi = torch.arange(T, device=device)[:, None]
    kj = torch.arange(S, device=device)[None, :]
    return (kj <= qi)[None, None]


def padding_mask_from_lengths(lengths: torch.Tensor, S: int) -> torch.Tensor:
    """(B, S) bool; True where the key position is valid."""
    return torch.arange(S, device=lengths.device)[None, :] < lengths[:, None]
