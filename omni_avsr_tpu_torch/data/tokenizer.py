"""Tokenizer interface, the HF tokenizer wrapper and the offline synthetic
tokenizer.

A numpy-only copy of `TokenizerBundle`, `load_hf_tokenizer` and
`synthetic_tokenizer` from the JAX package (`omni_avsr_tpu/data/tokenizer.py`);
the reference's template rules (`Omni_AVSR/lightning_OmniAVSR.py:53-91`)
are the same: Llama encodes "<bos> $A <eos>" with an added <pad> and the
four AV delimiters, Qwen "$A <eos>" with pad = EOS, and the prompt buffer is
input_ids[1:-1] (Llama) or [:-1] (Qwen).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np

AUDIO_SOS, AUDIO_EOS = "<audio>", "</audio>"
VIDEO_SOS, VIDEO_EOS = "<video>", "</video>"
DEFAULT_PAD = "<pad>"

IGNORE_INDEX = -100


@dataclass
class TokenizerBundle:
    """Uniform host-side tokenizer interface used by models/decode/serve."""

    family: str  # "llama" | "qwen"
    vocab_size: int
    bos_id: Optional[int]
    eos_id: int
    pad_id: int
    audio_sos_id: int
    audio_eos_id: int
    video_sos_id: int
    video_eos_id: int
    _encode_plain: Callable  # text -> ids WITHOUT specials
    _decode: Callable  # ids -> text

    def encode(self, text: str) -> List[int]:
        """With template: llama [bos]+ids+[eos]; qwen ids+[eos]."""
        ids = list(self._encode_plain(text))
        if self.family == "llama":
            return [self.bos_id] + ids + [self.eos_id]
        return ids + [self.eos_id]

    def prompt_ids(self, prompt: str) -> np.ndarray:
        """The slice the reference embeds as the prompt buffer."""
        ids = self.encode(prompt)
        start = 1 if self.family == "llama" else 0
        return np.asarray(ids[start:-1], dtype=np.int32)

    def decode(self, ids: Sequence[int]) -> str:
        specials = {
            self.bos_id, self.eos_id, self.pad_id,
            self.audio_sos_id, self.audio_eos_id,
            self.video_sos_id, self.video_eos_id,
        }
        return self._decode([i for i in ids if i not in specials])


def load_hf_tokenizer(llm_model: str) -> TokenizerBundle:
    """Wrap the HF tokenizer of `llm_model` (a hub name or a local
    directory; `transformers` is imported here, on first use)."""
    from transformers import AutoTokenizer

    family = "qwen" if "Qwen" in llm_model else "llama"
    tok = AutoTokenizer.from_pretrained(llm_model)
    delimiters = [AUDIO_SOS, AUDIO_EOS, VIDEO_SOS, VIDEO_EOS]
    if family == "llama":
        tok.add_special_tokens({"pad_token": DEFAULT_PAD,
                                "additional_special_tokens": delimiters})
        pad_id = tok.convert_tokens_to_ids(DEFAULT_PAD)
        bos_id = tok.bos_token_id
    else:
        tok.add_special_tokens({"additional_special_tokens": delimiters})
        pad_id = tok.eos_token_id
        bos_id = None
    tok.padding_side = "right"

    def encode_plain(text: str) -> List[int]:
        return tok(text, add_special_tokens=False).input_ids

    return TokenizerBundle(
        family=family,
        vocab_size=len(tok),
        bos_id=bos_id,
        eos_id=tok.eos_token_id,
        pad_id=pad_id,
        audio_sos_id=tok.convert_tokens_to_ids(AUDIO_SOS),
        audio_eos_id=tok.convert_tokens_to_ids(AUDIO_EOS),
        video_sos_id=tok.convert_tokens_to_ids(VIDEO_SOS),
        video_eos_id=tok.convert_tokens_to_ids(VIDEO_EOS),
        _encode_plain=encode_plain,
        _decode=lambda ids: tok.decode(ids, skip_special_tokens=True),
    )


def synthetic_tokenizer(family: str = "llama", base_vocab: int = 247) -> TokenizerBundle:
    """Offline word-hash tokenizer for tests and synthetic end-to-end runs.
    Words get ids in order of first use, wrapping at base_vocab; the top
    ids are the specials, as after resize_token_embeddings."""
    specials = ["<bos>", "<eos>", DEFAULT_PAD, AUDIO_SOS, AUDIO_EOS, VIDEO_SOS, VIDEO_EOS]
    vocab_size = base_vocab + len(specials)
    sid = {s: base_vocab + i for i, s in enumerate(specials)}
    word_to_id: dict = {}
    id_to_word: dict = {}

    def encode_plain(text: str) -> List[int]:
        ids = []
        for w in text.strip().split():
            if w not in word_to_id:
                nid = len(word_to_id) % base_vocab
                word_to_id[w] = nid
                id_to_word.setdefault(nid, w)
            ids.append(word_to_id[w])
        return ids

    def decode(ids: Sequence[int]) -> str:
        return " ".join(id_to_word.get(i, f"<unk{i}>") for i in ids)

    return TokenizerBundle(
        family=family,
        vocab_size=vocab_size,
        bos_id=sid["<bos>"] if family == "llama" else None,
        eos_id=sid["<eos>"],
        pad_id=sid[DEFAULT_PAD] if family == "llama" else sid["<eos>"],
        audio_sos_id=sid[AUDIO_SOS],
        audio_eos_id=sid[AUDIO_EOS],
        video_sos_id=sid[VIDEO_SOS],
        video_eos_id=sid[VIDEO_EOS],
        _encode_plain=encode_plain,
        _decode=decode,
    )
