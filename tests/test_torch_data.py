"""The port's data layer, WER and BLEU against the JAX package's, bit for bit
(tolerance: none; every array, file and number must be equal):
`generate_corpus` (files and manifests), `bucket_batches` (the C++ packer
and the Python packer), `collate`, `DataModule`'s train, validation and
test batches, `load_noise_bank`, the edit distance and BLEU statistics, and
`WerAccumulator` / `BleuScorer` on seeded strings. Also `load_hf_tokenizer`
on a local BPE tokenizer, and the native library's build into
`build/native/` (never into `native/`).
"""

import filecmp
import os

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import omni_avsr_tpu.data.batching as jbatching
import omni_avsr_tpu.utils.native as jnative
from omni_avsr_tpu.config import DataConfig as JaxDataConfig
from omni_avsr_tpu.data.datamodule import DataModule as JaxDataModule
from omni_avsr_tpu.data.noise import load_noise_bank as jax_noise_bank
from omni_avsr_tpu.data.synthetic import generate_corpus as jax_corpus
from omni_avsr_tpu.data.tokenizer import synthetic_tokenizer as jax_tok
from omni_avsr_tpu.utils.metrics import BleuScorer as JaxBleu, WerAccumulator as JaxWer
from omni_avsr_tpu_torch.config import DataConfig
from omni_avsr_tpu_torch.data import batching
from omni_avsr_tpu_torch.data.datamodule import DataModule
from omni_avsr_tpu_torch.data.noise import load_noise_bank
from omni_avsr_tpu_torch.data.synthetic import WORDS, generate_corpus
from omni_avsr_tpu_torch.data.tokenizer import synthetic_tokenizer
from omni_avsr_tpu_torch.utils import native
from omni_avsr_tpu_torch.utils.metrics import BleuScorer, WerAccumulator


def _same_batches(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The same corpus written by both packages: 5 train, 2 val, 4 test
    clips of 24-70 frames, seed 3."""
    root = tmp_path_factory.mktemp("corpus")
    kw = dict(n_train=5, n_val=2, n_test=4, max_frames=70, seed=3)
    return (root / "port", generate_corpus(str(root / "port"), **kw),
            root / "jax", jax_corpus(str(root / "jax"), **kw))


@pytest.mark.parametrize("compositional", [False, True])
def test_generate_corpus_same_files(tmp_path, corpora, compositional):
    """Every clip file and manifest byte-equal to the JAX package's."""
    if compositional:
        kw = dict(n_train=3, n_val=1, n_test=2, seed=5, compositional=True)
        ours, theirs = tmp_path / "port", tmp_path / "jax"
        csvs, jcsvs = generate_corpus(str(ours), **kw), jax_corpus(str(theirs), **kw)
    else:
        ours, csvs, theirs, jcsvs = corpora
    assert [os.path.basename(p) for p in csvs] == [os.path.basename(p) for p in jcsvs]
    for a, b in zip(csvs, jcsvs):
        assert open(a).read() == open(b).read()
    names = sorted(os.listdir(ours / "synth"))
    assert names == sorted(os.listdir(theirs / "synth")) and len(names) >= 12
    for n in names:
        assert filecmp.cmp(ours / "synth" / n, theirs / "synth" / n, shallow=False), n


def _lengths(seed, n=40):
    rng = np.random.RandomState(seed)
    return rng.randint(20, 300, size=n).tolist()


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("num_buckets,batch_size", [(1, None), (4, None), (400, 3), (7, 5)])
def test_bucket_batches_native_and_python(shuffle, num_buckets, batch_size):
    """The C++ packer (port vs JAX) and the Python packer (port vs the JAX
    package's fallback, which it takes when its library is unavailable)."""
    lengths = _lengths(num_buckets + int(shuffle))
    args = (lengths, 1000, num_buckets, shuffle, batch_size or 0, 11)
    ours = native.bucket_batches_native(*args)
    assert ours == jnative.bucket_batches_native(*args)
    assert sorted(i for b in ours for i in b) == list(range(len(lengths)))
    assert batching.bucket_batches(lengths, 1000, num_buckets, shuffle, batch_size, 11) == ours

    def unavailable(*a, **k):
        raise RuntimeError("native lib unavailable")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "bucket_batches_native", unavailable)
        want = jbatching.bucket_batches(lengths, 1000, num_buckets, shuffle, batch_size, 11)
    assert native.bucket_batches_py(lengths, 1000, num_buckets, shuffle, batch_size, 11) == want


def test_bucket_batches_over_budget():
    """A sample over the frame budget: both packages give it a batch of its
    own through the Python packer, with a warning."""
    lengths = _lengths(9, n=12) + [1500]
    with pytest.warns(UserWarning):
        ours = batching.bucket_batches(lengths, 1000, 4, shuffle=True, seed=2)
    with pytest.warns(UserWarning):
        assert ours == jbatching.bucket_batches(lengths, 1000, 4, shuffle=True, seed=2)
    assert [len(lengths) - 1] in ours


@pytest.mark.parametrize("family", ["llama", "qwen"])
@pytest.mark.parametrize("modality", ["audio", "video", "audiovisual"])
def test_collate_matches_jax(family, modality):
    """Train/val and test batches of one modality: tokens, labels, padded
    video and audio, lengths, the Whisper trim and the gold text."""
    rng = np.random.RandomState(4)
    samples = []
    for n in (37, 61, 29):
        s = {"text": " ".join(rng.choice(WORDS, size=rng.randint(1, 9))),
             "video": rng.randint(0, 255, (n, 12, 12, 3)).astype(np.uint8)}
        s["audio"] = (rng.randn(n * 640 - rng.randint(0, 500)) * 0.1).astype(np.float32)
        samples.append(s)
    for trainval in (True, False):
        tok, jtok = synthetic_tokenizer(family), jax_tok(family)
        ours = batching.collate(samples, tok, batching.CollateConfig(modality, is_trainval=trainval))
        want = jbatching.collate(samples, jtok, jbatching.CollateConfig(modality, is_trainval=trainval))
        _same_batches([ours], [want])


@pytest.mark.parametrize("modality", ["audiovisual", "audio", "video"])
def test_datamodule_batches_match_jax(corpora, modality):
    """Train batches of two epochs, validation batches and test batches of
    one and of three clips, array by array, read from the same corpus."""
    root, (train, val, test) = corpora[2], corpora[3]
    kw = dict(root_dir=str(root), train_file=train, val_file=val, test_file=test,
              max_frames_audiovisual=150, max_frames_audio=150, max_frames_video=150,
              train_num_buckets=3, num_workers=2)
    dm = DataModule(DataConfig(**kw), synthetic_tokenizer("llama"), modality=modality)
    jdm = JaxDataModule(JaxDataConfig(**kw), jax_tok("llama"), modality=modality)
    assert dm.steps_per_epoch() == jdm.steps_per_epoch() > 1
    for epoch in (0, 1):
        _same_batches(dm.train_batches(epoch), jdm.train_batches(epoch))
    _same_batches(dm.val_batches(), jdm.val_batches())
    for bs in (1, 3):
        _same_batches(dm.test_batches(bs), jdm.test_batches(bs))


def test_prefetch_raises_a_loader_error(corpora, tmp_path):
    """A clip that cannot be read surfaces as the loader's error."""
    root, (train, _, _) = corpora[0], corpora[1]
    bad = tmp_path / "bad.csv"
    bad.write_text(open(train).read() + "synth,missing.npy,40,0,hello world\n")
    dm = DataModule(DataConfig(root_dir=str(root), val_file=str(bad), num_workers=2),
                    synthetic_tokenizer("llama"))
    with pytest.raises(FileNotFoundError):
        list(dm.val_batches())


def test_noise_bank_matches_jax(tmp_path):
    """The synthesised babble and a bank read from a wav file."""
    with pytest.warns(UserWarning):
        ours = load_noise_bank(None, seconds=3.0, seed=7)
    with pytest.warns(UserWarning):
        want = jax_noise_bank(None, seconds=3.0, seed=7)
    assert ours.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(ours, want)
    from omni_avsr_tpu.data.synthetic import _write_wav

    path = str(tmp_path / "babble.wav")
    _write_wav(path, ours)
    np.testing.assert_array_equal(load_noise_bank(path), jax_noise_bank(path))


_words = st.lists(st.sampled_from(WORDS[:8] + ["Fox", "DOG"]), max_size=12).map(" ".join)


@settings(max_examples=60, deadline=None)
@given(pairs=st.lists(st.tuples(_words, _words), min_size=1, max_size=6))
def test_wer_and_bleu_match_jax(pairs):
    """Corpus WER and BLEU-4 of seeded reference/hypothesis strings: the
    same counts and scores as the JAX package's."""
    wer, jwer, bleu, jbleu = WerAccumulator(), JaxWer(), BleuScorer(), JaxBleu()
    for ref, hyp in pairs:
        wer.update(ref, hyp)
        jwer.update(ref, hyp)
        bleu.update(ref, hyp)
        jbleu.update(ref, hyp)
    assert (wer.total_edit_distance, wer.total_length, wer.wer) == (
        jwer.total_edit_distance, jwer.total_length, jwer.wer)
    np.testing.assert_array_equal(bleu.stats, jbleu.stats)
    assert bleu.score() == jbleu.score() and bleu.result_string() == jbleu.result_string()


@settings(max_examples=60, deadline=None)
@given(a=st.lists(st.integers(0, 5), max_size=15), b=st.lists(st.integers(0, 5), max_size=15))
def test_native_matches_python(a, b):
    """The C++ edit distance and BLEU statistics against their plain
    Python versions and the JAX package's."""
    d = native.edit_distance_native(a, b)
    assert d == native.edit_distance_py(a, b) == jnative.edit_distance_native(a, b)
    ours, plain, theirs = (np.zeros(10, np.int64) for _ in range(3))
    native.bleu_stats_native(a, b, ours)
    native.bleu_stats_py(a, b, plain)
    jnative.bleu_stats_native(a, b, theirs)
    np.testing.assert_array_equal(ours, plain)
    np.testing.assert_array_equal(ours, theirs)


def test_native_library_location():
    """The library is built under build/native/ keyed by the source hash;
    the repository's native/ directory is only read."""
    native.load()
    path = native.library_path()
    assert path.exists() and path.parent == native.ROOT / "build" / "native"
    assert native.SOURCE.parent.name == "native" and path.parent != native.SOURCE.parent


def test_load_hf_tokenizer_matches_jax(tmp_path):
    """A local byte-level BPE tokenizer (Llama-style and Qwen-style), built
    by the port's `build_local_bpe_tokenizer`, through both packages'
    `load_hf_tokenizer`: the same special ids, vocabulary, encodings,
    prompt slices and decodings."""
    pytest.importorskip("transformers")
    from omni_avsr_tpu.data.tokenizer import load_hf_tokenizer as jax_load
    from omni_avsr_tpu_torch.data.local_tokenizer import build_local_bpe_tokenizer
    from omni_avsr_tpu_torch.data.tokenizer import load_hf_tokenizer

    for family, name in (("llama", "Llama-3.2-1B-local"), ("qwen", "Qwen2.5-0.5B-local")):
        path = str(tmp_path / name)
        build_local_bpe_tokenizer(path, family=family)
        ours, theirs = load_hf_tokenizer(path), jax_load(path)
        fields = ("family", "vocab_size", "bos_id", "eos_id", "pad_id", "audio_sos_id",
                  "audio_eos_id", "video_sos_id", "video_eos_id")
        assert [getattr(ours, f) for f in fields] == [getattr(theirs, f) for f in fields]
        assert ours.family == family
        for text in ("hello world", "transcribe speech to text.", "", "<audio>x</audio> ü"):
            ids = ours.encode(text)
            assert ids == theirs.encode(text)
            assert ours.decode(ids) == theirs.decode(ids)
        np.testing.assert_array_equal(ours.prompt_ids("Transcribe video to text."),
                                      theirs.prompt_ids("Transcribe video to text."))
