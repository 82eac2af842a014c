"""AV-HuBERT masked-prediction pre-training (port of
`omni_avsr_tpu/models/avhubert_pretrain.py`; reference
`av_hubert/avhubert/hubert.py:443-676`, `hubert_criterion.py:40-169`):
span masking over the fused features, the encoder, a projection into the
space of learned cluster ("unit") embeddings, cosine logits over a
temperature, and the cross-entropy on the masked (and, weighted, the
unmasked) frames.

The span mask has fairseq's 'static' selection, computed on the device:
num_spans = max(int(p * len / L + u), min_masks), uniform starts, span
length L, overlaps allowed. Modality dropout (`hubert.py:605-615`): with
probability `modality_dropout` one modality is zeroed before the concat
fuse, the audio one with probability `audio_dropout` within that event.

Every draw comes from `rng`: a threefry key (`utils/prng.py`), split as the
JAX package splits it (`k_mask, k_mod, k_aud = split(rng, 3)`, then
`k_n, k_s = split(k_mask)`), which draws its bits; or a torch.Generator.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import AVHubertConfig
from ..ops.augment import Rng, _rand, subkeys
from ..ops.norms import layer_norm
from .avhubert import avhubert_encoder
from .common import Params, linear


def compute_span_mask(rng: Rng, B: int, T: int, lengths: Optional[torch.Tensor],
                      mask_prob: float, mask_length: int, min_masks: int = 2,
                      max_spans: Optional[int] = None, device="cpu") -> torch.Tensor:
    """(B, T) bool span mask on `device` (the lengths' device when given)."""
    if max_spans is None:
        max_spans = max(int(mask_prob * T / mask_length + 1), min_masks) + 1
    dev = lengths.device if lengths is not None else torch.device(device)
    k_n, k_s = subkeys(rng, 2)
    lens = lengths.long() if lengths is not None else torch.full((B,), T, device=dev)
    u = _rand(k_n, (B,), dev)
    n_spans = torch.clamp((mask_prob * lens.float() / mask_length + u).int(), min=min_masks)
    n_spans = torch.clamp(n_spans, max=max_spans)
    span_max = torch.clamp(lens - mask_length, min=1)
    starts = (_rand(k_s, (B, max_spans), dev) * span_max[:, None].float()).int()
    active = torch.arange(max_spans, device=dev)[None] < n_spans[:, None]
    idx = torch.arange(T, device=dev)[None, None]
    covered = ((idx >= starts[:, :, None]) & (idx < (starts + mask_length)[:, :, None])
               & active[:, :, None])
    mask = covered.any(dim=1)
    if lengths is not None:
        mask &= torch.arange(T, device=dev)[None] < lens[:, None]
    return mask


def compute_unit_logits(head: Params, x: torch.Tensor, sim_type: str = "cosine",
                        logit_temp: float = 0.1) -> torch.Tensor:
    """final_proj, then the cosine (or dot) similarity with each unit's
    embedding over the temperature (`hubert.py:577-590`): (B, T, V)."""
    proj = linear(x, head["final_proj"])  # (B, T, F)
    emb = head["label_embs"].to(proj.dtype)  # (V, F)
    nom = torch.einsum("btf,vf->btv", proj, emb)
    if sim_type == "dot":
        logits = nom
    else:
        denom = torch.linalg.norm(proj, dim=-1, keepdim=True) * torch.linalg.norm(emb, dim=-1)
        logits = nom / torch.clamp(denom, min=1e-6)
    return logits / logit_temp


def avhubert_pretrain_loss(
    params: Params,  # the AV-HuBERT encoder's
    head: Params,  # the pre-training head's
    cfg: AVHubertConfig,
    video_feats: torch.Tensor,  # (B, T, D) per-modality features after their projections
    audio_feats: torch.Tensor,  # (B, T, D)
    targets: torch.Tensor,  # (B, T) cluster ids
    lengths: Optional[torch.Tensor],
    rng: Rng,
    mask_prob: float = 0.8,
    mask_length: int = 10,
    modality_dropout: float = 0.0,
    audio_dropout: float = 0.0,
    sim_type: str = "cosine",
    logit_temp: float = 0.1,
    pred_masked_weight: float = 1.0,
    pred_nomask_weight: float = 0.0,
    remat: str = "off",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The masked-prediction loss and its aux metrics (`loss_masked`,
    `loss_unmasked`, `acc_masked`). The encoder runs without dropout, as
    the JAX step runs it; `remat` is its layers' remat policy."""
    B, T, D = video_feats.shape
    dev = video_feats.device
    k_mask, k_mod, k_aud = subkeys(rng, 3)
    if modality_dropout > 0:
        drop = _rand(k_mod, (B, 1, 1), dev) < modality_dropout
        drop_audio = _rand(k_aud, (B, 1, 1), dev) < audio_dropout
        audio_feats = torch.where(drop & drop_audio, torch.zeros_like(audio_feats), audio_feats)
        video_feats = torch.where(drop & ~drop_audio, torch.zeros_like(video_feats), video_feats)

    fused = torch.cat([audio_feats, video_feats], dim=-1)
    fn = params["fuse_norm"]
    feats = linear(layer_norm(fused, fn["scale"], fn["bias"]), params["post_extract_proj"])

    mask = compute_span_mask(k_mask, B, T, lengths, mask_prob, mask_length, device=dev)
    feats = torch.where(mask[..., None], head["mask_emb"].to(feats.dtype), feats)

    x = avhubert_encoder(params, cfg, feats, lengths, remat=remat)
    logits = compute_unit_logits(head, x, sim_type, logit_temp).float()

    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]  # (B, T)
    valid = (torch.arange(T, device=dev)[None] < lengths[:, None] if lengths is not None
             else torch.ones((B, T), dtype=torch.bool, device=dev))
    m = mask & valid
    u = ~mask & valid
    zero = torch.zeros_like(nll)
    loss_m = torch.where(m, nll, zero).sum() / m.sum().clamp(min=1)
    loss_u = torch.where(u, nll, zero).sum() / u.sum().clamp(min=1)
    loss = pred_masked_weight * loss_m + pred_nomask_weight * loss_u
    hit = (torch.argmax(logits, dim=-1) == targets.long()) & m
    acc_m = hit.sum() / m.sum().clamp(min=1)
    return loss, {"loss_masked": loss_m, "loss_unmasked": loss_u, "acc_masked": acc_m}
