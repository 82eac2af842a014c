"""Whether what the timed path served is correct: a sample of the window's
finished requests, drawn from the seed with the longest in it, held
against the plain reference (`reference/omni.py`) on the same media, at
the window each request was served in.

Numbers compared (log-probabilities in nats, from the reference at the
configuration's weight precision):
  - `beam_gap`: over the served tokens, the widest gap by which a served
    token lies below the reference's 2K-th best at its position (a beam
    step keeps the top 2K of the candidates), and an EOS that ended the
    hypothesis below its K-th best (only the top K may finish);
  - `selection_gap`: the widest gap by which a served hypothesis's score,
    as the beam search scores it (its log-probabilities summed, over its
    length to the power `length_penalty`), lies below the best score the
    reference's own beam search finds from the same prefix;
  - `unanswered`: requests of the window that never got a result.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from . import weights
from .reference import omni as ref

LENGTH_PENALTY = 1.0  # the served configuration's (Hugging Face's default)


def served_tokens(row, eos: int):
    """(tokens up to the first EOS, whether an EOS ended them)."""
    toks = [int(t) for t in row]
    if eos in toks:
        return toks[: toks.index(eos)], True
    return toks, False


def sample(reqs: List, served: Dict[int, torch.Tensor], n: int, seed: int) -> List:
    """Up to n requests among those served, drawn from `seed`, the longest
    clip always in."""
    rng = np.random.default_rng(seed + 7)
    pool = [r for r in reqs if r.rid in served]
    if not pool or n <= 0:
        return []
    longest = max(pool, key=lambda r: r.frames)
    rest = [r for r in pool if r is not longest]
    k = min(len(rest), n - 1)
    return [longest] + [rest[i] for i in sorted(rng.choice(len(rest), k, replace=False))]


def request_windows(calls: List[dict], reqs_by_id: Dict, pad_multiple: int) -> Dict[int, ref.Window]:
    """The window each request was served in: its decode call's padding,
    worked out from the call's clips."""
    out = {}
    for c in calls:
        rs = [reqs_by_id[i] for i in c["rids"] if i is not None]
        if not rs:
            continue
        win = ref.batch_window([r.frames for r in rs], [r.frames * 640 for r in rs],
                               c["modality"], pad_multiple)
        for r in rs:
            out[r.rid] = win
    return out


def compare(cfg: dict, seed: int, device, reqs: List, served: Dict[int, torch.Tensor],
            calls: List[dict], n: int, bits: Optional[int],
            dtype=torch.bfloat16) -> Dict[str, float]:
    """The compared numbers of one run (`beam_gap`, `selection_gap`), over
    the sample. The weights are drawn again from `seed` in `dtype`, as the
    program's were."""
    chosen = sample(reqs, served, n, seed)
    if not chosen:
        return {}
    wins = request_windows(calls, {r.rid: r for r in reqs}, cfg["serving"]["video_pad_multiple"])
    tree = weights.draw(cfg, seed, device, dtype)
    model = ref.Reference(cfg, tree, bits, device)
    eos, max_new = model.vocab.eos, cfg["serving"]["max_new_tokens"]
    rreqs, ends = [], []
    for r in chosen:
        toks, ended = served_tokens(served[r.rid], eos)
        rreqs.append(ref.Request(r.item.get("audio"), r.item.get("video"), r.modality,
                                 wins[r.rid], toks))
        ends.append(ended)
    beam_gap, scores = 0.0, []
    for r, rr, ended, lp in zip(chosen, rreqs, ends, model.logprobs(rreqs)):
        K, n_tok = r.beams, len(rr.served)
        toks = torch.as_tensor(rr.served, dtype=torch.long, device=lp.device)
        got = lp[torch.arange(n_tok, device=lp.device), toks]
        if n_tok:
            kth = lp[:n_tok].topk(2 * K, dim=-1).values[:, -1]
            beam_gap = max(beam_gap, torch.clamp(kth - got, min=0).max().item())
        total = got.sum().item()
        if ended:
            kth = lp[n_tok].topk(K).values[-1]
            beam_gap = max(beam_gap, max(0.0, (kth - lp[n_tok, eos]).item()))
            total += lp[n_tok, eos].item()
        scores.append(total / float(max(n_tok, 1) if ended else max_new) ** LENGTH_PENALTY)
    selection_gap = 0.0
    for modality in sorted({r.modality for r in chosen}):
        idx = [i for i, r in enumerate(chosen) if r.modality == modality]
        K = chosen[idx[0]].beams
        best = model.beam_search([rreqs[i] for i in idx], K, max_new, LENGTH_PENALTY)
        selection_gap = max([selection_gap] + [b - scores[i] for b, i in zip(best, idx)])
    del tree, model
    return {"beam_gap": beam_gap, "selection_gap": selection_gap}
