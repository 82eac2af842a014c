"""Subword vocabularies: a pure-Python BPE with sentencepiece-style pieces,
and the letter and word dictionaries (the port's own copy of
`omni_avsr_tpu/data/subword.py`, which imports no JAX; the port imports
nothing of the JAX package).

The reference builds its seq2seq target vocabulary with sentencepiece
(`av_hubert/avhubert/preparation/gen_subword.py:31-66`: 1000 pieces,
specials <s>=0 <pad>=1 </s>=2 <unk>=3, written as a fairseq dictionary).
Without sentencepiece, `train_bpe` is a self-contained BPE (the reference
function's default `model_type="bpe"`) over whitespace-split words with
the word-boundary mark "▁": merges in a fixed order (the highest pair
count, ties broken lexicographically), so the same corpus gives the same
pieces on every machine. `write_fairseq_dict`'s file loads in
`cli/eval_avhubert_s2s.py::FairseqDictionary` with the piece ids of
`BPEEncoder`: the same specials, then file order = piece order.

`letter_dict` is the wav2vec-style letter inventory (`dict.ltr.txt`, "|"
between words) and `word_dict` the word one, as the preparation README
builds them. Host-only: no torch.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

WORD_MARK = "▁"  # ▁ (spm word-boundary prefix)
SPECIALS = ["<s>", "<pad>", "</s>", "<unk>"]  # ids 0..3 (gen_subword.py:26-29)


def _word_counts(texts: Iterable[str]) -> Counter:
    c: Counter = Counter()
    for t in texts:
        for w in t.strip().split():
            c[w] += 1
    return c


def train_bpe(
    texts: Iterable[str], vocab_size: int = 1000
) -> Tuple[List[str], List[Tuple[str, str]], Counter]:
    """Classic BPE over word types (weighted by frequency). Returns
    (pieces, merges, piece_counts); pieces exclude the 4 specials, so the
    final vocabulary size is len(pieces) + 4 <= vocab_size."""
    words = _word_counts(texts)
    # seed inventory: characters, first char of each word carries the mark
    seqs: Dict[Tuple[str, ...], int] = {}
    for w, n in words.items():
        seq = tuple([WORD_MARK + w[0]] + list(w[1:]))
        seqs[seq] = seqs.get(seq, 0) + n

    alphabet = Counter()
    for seq, n in seqs.items():
        for ch in seq:
            alphabet[ch] += n
    pieces = sorted(alphabet)
    merges: List[Tuple[str, str]] = []

    budget = vocab_size - len(SPECIALS)
    while len(pieces) < budget:
        pairs: Counter = Counter()
        for seq, n in seqs.items():
            for a, b in zip(seq, seq[1:]):
                pairs[(a, b)] += n
        if not pairs:
            break
        # deterministic: highest count, ties broken lexicographically
        (a, b), cnt = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        if cnt < 2:
            break
        merged = a + b
        merges.append((a, b))
        pieces.append(merged)
        new_seqs: Dict[Tuple[str, ...], int] = {}
        for seq, n in seqs.items():
            out: List[str] = []
            i = 0
            while i < len(seq):
                if i + 1 < len(seq) and seq[i] == a and seq[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            key = tuple(out)
            new_seqs[key] = new_seqs.get(key, 0) + n
        seqs = new_seqs

    counts = Counter()
    for seq, n in seqs.items():
        for p in seq:
            counts[p] += n
    # pieces never produced by the final segmentation keep count 0
    for p in pieces:
        counts.setdefault(p, 0)
    return pieces, merges, counts


class BPEEncoder:
    """Encode/decode with a trained BPE model (merge-order application,
    the standard BPE inference rule)."""

    def __init__(self, pieces: Sequence[str], merges: Sequence[Tuple[str, str]]):
        self.pieces = list(pieces)
        self.merges = {tuple(m): i for i, m in enumerate(merges)}
        self.symbols = SPECIALS + self.pieces
        self.index = {s: i for i, s in enumerate(self.symbols)}
        self.bos, self.pad, self.eos, self.unk = 0, 1, 2, 3

    def encode_pieces(self, text: str) -> List[str]:
        out: List[str] = []
        for w in text.strip().split():
            seq = [WORD_MARK + w[0]] + list(w[1:])
            while len(seq) > 1:
                ranked = [
                    (self.merges.get((a, b)), i)
                    for i, (a, b) in enumerate(zip(seq, seq[1:]))
                ]
                ranked = [(r, i) for r, i in ranked if r is not None]
                if not ranked:
                    break
                _, i = min(ranked)
                seq = seq[:i] + [seq[i] + seq[i + 1]] + seq[i + 2:]
            out.extend(seq)
        return out

    def encode(self, text: str) -> List[int]:
        return [self.index.get(p, self.unk) for p in self.encode_pieces(text)]

    def decode(self, ids: Sequence[int]) -> str:
        keep = [i for i in ids if self.unk <= i < len(self.symbols)]
        s = "".join("⁇" if i == self.unk else self.symbols[i] for i in keep)
        return s.replace(WORD_MARK, " ").strip()

    def save(self, prefix: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
        with open(prefix + ".model.json", "w") as f:
            json.dump({"pieces": self.pieces,
                       "merges": [list(m) for m, _ in
                                  sorted(self.merges.items(), key=lambda kv: kv[1])]},
                      f)

    @classmethod
    def load(cls, prefix: str) -> "BPEEncoder":
        with open(prefix + ".model.json") as f:
            obj = json.load(f)
        return cls(obj["pieces"], [tuple(m) for m in obj["merges"]])


def write_fairseq_dict(path: str, items: Sequence[Tuple[str, int]]) -> str:
    """fairseq dictionary file: `<symbol> <count>` per line, file order =
    ids 4.. after the implicit specials (FairseqDictionary convention)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for sym, n in items:
            f.write(f"{sym} {n}\n")
    return path


def letter_dict(texts: Iterable[str]) -> List[Tuple[str, int]]:
    """wav2vec-style letter inventory with '|' as the word boundary."""
    c: Counter = Counter()
    for t in texts:
        words = t.strip().split()
        for w in words:
            for ch in w:
                c[ch] += 1
        c["|"] += len(words)
    return sorted(c.items(), key=lambda kv: (-kv[1], kv[0]))


def word_dict(texts: Iterable[str]) -> List[Tuple[str, int]]:
    return sorted(_word_counts(texts).items(), key=lambda kv: (-kv[1], kv[0]))
