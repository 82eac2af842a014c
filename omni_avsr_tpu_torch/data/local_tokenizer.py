"""An offline byte-level BPE tokenizer in the shape of the Llama-3 or
Qwen2.5 one (the port's own copy of `omni_avsr_tpu/data/local_tokenizer.py`;
the port imports nothing of the JAX package).

With no network the real Llama and Qwen tokenizer files cannot be
fetched. Where `transformers` and `tokenizers` are installed,
`build_local_bpe_tokenizer` trains a small byte-level BPE that goes
through the same HF fast-tokenizer machinery (TemplateProcessing, added
specials, padding) the reference manipulates in
`Omni_AVSR/lightning_OmniAVSR.py:53-91`, so that
`data/tokenizer.py::load_hf_tokenizer` can be held token for token to the
reference's construction without the real files.

`family="llama"`: `<|begin_of_text|>` / `<|end_of_text|>`, no pad token;
`family="qwen"`: `<|endoftext|>` as both eos and pad, no bos. Both
packages are imported inside the function. The H100 machine has neither,
so `chip_smoke.py` does not call it; the CPU tests do, where they are
installed.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

_DEFAULT_CORPUS = [
    "set your course by the stars not by the lights of passing ships",
    "the quick brown fox jumps over the lazy dog",
    "transcribe speech to text",
    "transcribe video to text",
    "transcribe speech and video to text",
    "hello world this is a tiny corpus for a tiny tokenizer",
    "numbers 0 1 2 3 4 5 6 7 8 9 punctuation , . ! ? ' -",
]


def build_local_bpe_tokenizer(
    out_dir: str,
    family: str = "llama",
    vocab_size: int = 384,
    corpus: Optional[Iterable[str]] = None,
):
    """Train a tiny byte-level BPE tokenizer and save it HF-loadable.

    Returns the directory path, which `transformers.AutoTokenizer
    .from_pretrained` accepts. The saved tokenizer mirrors the *pristine*
    upstream state (before the reference's surgery): Llama ships with a bos
    and eos but NO pad token and NO AV delimiter specials; Qwen ships with
    `<|endoftext|>` as eos+pad and no bos (`lightning_OmniAVSR.py:54-91`).
    """
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers
    from transformers import PreTrainedTokenizerFast

    if family == "llama":
        bos, eos = "<|begin_of_text|>", "<|end_of_text|>"
        specials = [bos, eos]
    elif family == "qwen":
        bos, eos = None, "<|endoftext|>"
        specials = [eos]
    else:
        raise ValueError(f"unknown family {family!r}")

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_size,
        special_tokens=specials,
        # full byte alphabet so ANY unicode input round-trips
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
    )
    tok.train_from_iterator(list(corpus or _DEFAULT_CORPUS), trainer)

    kwargs = dict(eos_token=eos)
    if bos is not None:
        kwargs["bos_token"] = bos
    else:
        # Qwen2.5 ships pad = <|endoftext|> in tokenizer_config
        kwargs["pad_token"] = eos
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, **kwargs)
    os.makedirs(out_dir, exist_ok=True)
    fast.save_pretrained(out_dir)
    return out_dir
