"""Subword, letter and word dictionaries for the seq2seq targets (port of
`omni_avsr_tpu/cli/gen_subword.py`, the same flags and the same files byte
for byte). It runs on the host only, with no torch: no `--device`.

The reference's `av_hubert/avhubert/preparation/gen_subword.py` trains a
sentencepiece vocabulary and writes it as a fairseq dictionary; this CLI
does so with `data/subword.py`'s BPE. It reads the transcripts from a
manifest CSV (the fifth column, the repository's manifest layout) or a
plain text file (one utterance a line).

  python -m omni_avsr_tpu_torch.cli.gen_subword \\
      --input data/train.csv --output-dir data/spm --model-type bpe \\
      --vocab-size 1000
  # -> data/spm/spm_bpe1000.model.json + data/spm/dict.wrd.txt

`--model-type char` writes `dict.ltr.txt` and `word` `dict.wrd.txt`
(`--dict-name` renames either); the dictionary loads in
`cli/eval_avhubert_s2s.py::FairseqDictionary`.
"""

from __future__ import annotations

import argparse
import os
from typing import List


def read_texts(path: str) -> List[str]:
    texts = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split(",")
            texts.append(parts[4] if len(parts) >= 5 else line)
    return texts


def main(argv=None):
    p = argparse.ArgumentParser("gen_subword")
    p.add_argument("--input", required=True,
                   help="manifest csv (text in col 5) or plain text file")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--model-type", default="bpe", choices=["bpe", "char", "word"])
    p.add_argument("--vocab-size", type=int, default=1000)
    p.add_argument("--dict-name", default=None,
                   help="dictionary filename (default dict.wrd.txt / dict.ltr.txt)")
    args = p.parse_args(argv)

    from ..data.subword import (
        BPEEncoder,
        letter_dict,
        train_bpe,
        word_dict,
        write_fairseq_dict,
    )

    texts = read_texts(args.input)
    print(f"{len(texts)} transcripts from {args.input}")
    os.makedirs(args.output_dir, exist_ok=True)

    if args.model_type == "bpe":
        pieces, merges, counts = train_bpe(texts, vocab_size=args.vocab_size)
        enc = BPEEncoder(pieces, merges)
        prefix = os.path.join(args.output_dir, f"spm_bpe{args.vocab_size}")
        enc.save(prefix)
        name = args.dict_name or "dict.wrd.txt"
        path = write_fairseq_dict(os.path.join(args.output_dir, name),
                                  [(p_, counts[p_]) for p_ in pieces])
        print(f"wrote {prefix}.model.json + {path} "
              f"({len(pieces) + 4} symbols incl. specials)")
    elif args.model_type == "char":
        name = args.dict_name or "dict.ltr.txt"
        items = letter_dict(texts)
        path = write_fairseq_dict(os.path.join(args.output_dir, name), items)
        print(f"wrote {path} ({len(items) + 4} symbols incl. specials)")
    else:
        name = args.dict_name or "dict.wrd.txt"
        items = word_dict(texts)[: args.vocab_size - 4]
        path = write_fairseq_dict(os.path.join(args.output_dir, name), items)
        print(f"wrote {path} ({len(items) + 4} symbols incl. specials)")


if __name__ == "__main__":
    main()
