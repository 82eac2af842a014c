"""WER and BLEU metrics (port of `omni_avsr_tpu/utils/metrics.py`).

WER parity with `lightning_OmniAVSR.py:40-42, 206-219`:
  distance = edit_distance(ref.lower().split(), hyp.lower().split())
  WER = sum(distance) / sum(len(ref.lower().split()))
BLEU parity with fairseq's libbleu scorer
(`av_hubert/fairseq/fairseq/clib/libbleu/libbleu.cpp` + `fairseq/scoring/
bleu.py::Scorer`): corpus-level clipped n-gram matching, orders 1-4,
geometric mean with brevity penalty.
Both run in the repository's C++ library (`utils/native.py`), which
raises if it does not build.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from .native import bleu_stats_native, edit_distance_native


def _to_ids(words: List[str], vocab: Dict[str, int]) -> List[int]:
    return [vocab.setdefault(w, len(vocab)) for w in words]


def compute_word_level_distance(ref: str, hyp: str) -> int:
    vocab: Dict[str, int] = {}
    a = _to_ids(ref.lower().split(), vocab)
    b = _to_ids(hyp.lower().split(), vocab)
    return edit_distance_native(a, b)


@dataclass
class WerAccumulator:
    total_edit_distance: int = 0
    total_length: int = 0

    def update(self, ref: str, hyp: str) -> None:
        self.total_edit_distance += compute_word_level_distance(ref, hyp)
        self.total_length += len(ref.lower().split())

    @property
    def wer(self) -> float:
        if self.total_length == 0:
            return 0.0
        return self.total_edit_distance / self.total_length


@dataclass
class BleuScorer:
    """Corpus BLEU-4 accumulator (fairseq Scorer semantics: smoothed
    per-order precision `(match + 1) / (count + 1)` when order > 1 has no
    matches is NOT applied — like libbleu, zero matches at any order give
    BLEU 0; `score()` uses the plain geometric mean + brevity penalty).

    Accepts token id sequences (`update_ids`) or whitespace text (`update`,
    words mapped to ids via a shared vocab, matching WER's tokenisation).
    Stats layout: [ref_len, hyp_len, match1, count1, ..., match4, count4].
    """

    stats: np.ndarray = field(default_factory=lambda: np.zeros(10, np.int64))
    _vocab: Dict[str, int] = field(default_factory=dict)

    def update_ids(self, ref_ids: List[int], hyp_ids: List[int]) -> None:
        bleu_stats_native(ref_ids, hyp_ids, self.stats)

    def update(self, ref: str, hyp: str) -> None:
        self.update_ids(_to_ids(ref.lower().split(), self._vocab),
                        _to_ids(hyp.lower().split(), self._vocab))

    def precision(self, order: int) -> float:
        match = int(self.stats[2 + 2 * (order - 1)])
        count = int(self.stats[3 + 2 * (order - 1)])
        return match / count if count > 0 else 0.0

    @property
    def brevity_penalty(self) -> float:
        ref_len, hyp_len = int(self.stats[0]), int(self.stats[1])
        if hyp_len == 0:
            return 0.0
        return min(1.0, math.exp(1.0 - ref_len / hyp_len))

    def score(self, order: int = 4) -> float:
        """Corpus BLEU in percent (0-100)."""
        ps = [self.precision(k) for k in range(1, order + 1)]
        if any(p == 0.0 for p in ps):
            return 0.0
        log_mean = sum(math.log(p) for p in ps) / order
        return 100.0 * self.brevity_penalty * math.exp(log_mean)

    def result_string(self, order: int = 4) -> str:
        ps = "/".join(f"{100.0 * self.precision(k):.1f}" for k in range(1, order + 1))
        return (f"BLEU{order} = {self.score(order):.2f}, {ps} "
                f"(BP={self.brevity_penalty:.3f}, ratio={int(self.stats[1]) / max(int(self.stats[0]), 1):.3f}, "
                f"syslen={int(self.stats[1])}, reflen={int(self.stats[0])})")
