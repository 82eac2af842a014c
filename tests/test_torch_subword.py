"""The port's subword vocabularies (`omni_avsr_tpu_torch/data/subword.py`),
their CLI (`cli/gen_subword.py`) and the offline tokenizer
(`data/local_tokenizer.py`) against the JAX package's copies, which
import no JAX, on one seeded corpus: everything must agree exactly.

  - `train_bpe`: the pieces, the merges in order and the piece counts;
  - `BPEEncoder.encode_pieces`, `encode`, `decode` (unseen characters
    through <unk>) and the `save` / `load` round trip, whose files are
    byte-identical;
  - `letter_dict`, `word_dict`, `write_fairseq_dict`;
  - both CLIs (JAX `main` in process) write byte-identical output
    directories for bpe, char and word, and the port's dictionary loads
    in the port's `FairseqDictionary` with `BPEEncoder`'s piece ids;
  - `build_local_bpe_tokenizer` of both packages saves the same
    `tokenizer.json` (skipped without `transformers`).
"""

import filecmp
import os

import numpy as np
import pytest

WORDS = ("the cat sat on mat ran a dog bit big red sun set over hill "
         "transcribe speech video text hello world").split()


def _corpus(n: int = 120, seed: int = 0):
    rng = np.random.RandomState(seed)
    return [" ".join(rng.choice(WORDS, size=rng.randint(2, 9))) for _ in range(n)]


TEXTS = _corpus()
PROBES = ["the cat sat on the mat", "hello world", "transcribe zzz qq", "", "bigredsun"]


@pytest.mark.parametrize("vocab", [30, 60, 200])
def test_train_bpe_and_encoder_match_jax(tmp_path, vocab):
    from omni_avsr_tpu.data import subword as J
    from omni_avsr_tpu_torch.data import subword as P

    pieces, merges, counts = P.train_bpe(TEXTS, vocab_size=vocab)
    assert (pieces, merges, counts) == J.train_bpe(TEXTS, vocab_size=vocab)
    # the characters always stay: a budget below the alphabet merges nothing
    assert len(pieces) + 4 <= vocab or not merges
    assert P.SPECIALS == J.SPECIALS and P.WORD_MARK == J.WORD_MARK
    enc, ref = P.BPEEncoder(pieces, merges), J.BPEEncoder(pieces, merges)
    assert enc.symbols == ref.symbols and enc.index == ref.index
    for text in PROBES + TEXTS[:20]:
        assert enc.encode_pieces(text) == ref.encode_pieces(text)
        ids = enc.encode(text)
        assert ids == ref.encode(text)
        assert enc.decode(ids) == ref.decode(ids)
    assert enc.unk in enc.encode("zzz")
    enc.save(str(tmp_path / "port" / "m"))
    ref.save(str(tmp_path / "jax" / "m"))
    assert filecmp.cmp(tmp_path / "port" / "m.model.json", tmp_path / "jax" / "m.model.json",
                       shallow=False)
    back = P.BPEEncoder.load(str(tmp_path / "port" / "m"))
    assert back.pieces == enc.pieces and back.merges == enc.merges
    assert [back.encode(t) for t in PROBES] == [enc.encode(t) for t in PROBES]


def test_dictionaries_match_jax(tmp_path):
    from omni_avsr_tpu.data import subword as J
    from omni_avsr_tpu_torch.data import subword as P

    assert P.letter_dict(TEXTS) == J.letter_dict(TEXTS)
    assert P.word_dict(TEXTS) == J.word_dict(TEXTS)
    a = P.write_fairseq_dict(str(tmp_path / "a" / "dict.txt"), P.word_dict(TEXTS))
    b = J.write_fairseq_dict(str(tmp_path / "b" / "dict.txt"), J.word_dict(TEXTS))
    assert filecmp.cmp(a, b, shallow=False)


@pytest.mark.parametrize("model_type", ["bpe", "char", "word"])
def test_gen_subword_cli_matches_jax(tmp_path, model_type):
    from omni_avsr_tpu.cli.gen_subword import main as jax_main
    from omni_avsr_tpu_torch.cli.eval_avhubert_s2s import FairseqDictionary
    from omni_avsr_tpu_torch.cli.gen_subword import main
    from omni_avsr_tpu_torch.data.subword import BPEEncoder

    manifest = tmp_path / "train.csv"
    manifest.write_text("\n".join(f"lrs3,clip{i}.mp4,100,0,{t}" for i, t in enumerate(TEXTS)))
    args = ["--input", str(manifest), "--model-type", model_type, "--vocab-size", "60"]
    main(args + ["--output-dir", str(tmp_path / "port")])
    jax_main(args + ["--output-dir", str(tmp_path / "jax")])
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and names
    cmp = filecmp.dircmp(tmp_path / "port", tmp_path / "jax")
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "port", tmp_path / "jax", names,
                                           shallow=False)
    assert not mismatch and not errors and not cmp.left_only and not cmp.right_only
    dict_name = "dict.ltr.txt" if model_type == "char" else "dict.wrd.txt"
    d = FairseqDictionary(str(tmp_path / "port" / dict_name))
    assert d.symbols[:4] == ["<s>", "<pad>", "</s>", "<unk>"]
    if model_type == "bpe":
        enc = BPEEncoder.load(str(tmp_path / "port" / "spm_bpe60"))
        assert d.symbols == enc.symbols  # the dictionary's ids are the encoder's
        ids = enc.encode("the cat sat")
        assert [d.index[enc.symbols[i]] for i in ids] == ids
    # a plain text file (one utterance a line) reads the same transcripts
    plain = tmp_path / "train.txt"
    plain.write_text("\n".join(TEXTS))
    main(["--input", str(plain), "--model-type", model_type, "--vocab-size", "60",
          "--output-dir", str(tmp_path / "plain")])
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "port", tmp_path / "plain", names,
                                           shallow=False)
    assert not mismatch and not errors


@pytest.mark.parametrize("family", ["llama", "qwen"])
def test_local_tokenizer_matches_jax(tmp_path, family):
    pytest.importorskip("transformers")
    from omni_avsr_tpu.data.local_tokenizer import build_local_bpe_tokenizer as jax_build
    from omni_avsr_tpu_torch.data.local_tokenizer import build_local_bpe_tokenizer

    a = build_local_bpe_tokenizer(str(tmp_path / "port"), family=family)
    b = jax_build(str(tmp_path / "jax"), family=family)
    assert filecmp.cmp(os.path.join(a, "tokenizer.json"), os.path.join(b, "tokenizer.json"),
                       shallow=False)
    with pytest.raises(ValueError, match="unknown family"):
        build_local_bpe_tokenizer(str(tmp_path / "x"), family="gpt")
