"""The port's AV-HuBERT family CLIs against the JAX package, on the CPU.

- `train_avhubert_s2s`'s step (`S2STrainer`) against the JAX CLI's
  `train_step` (rebuilt here as that CLI builds it: the same loss, clip 10
  and masked AdamW) from one tree under one threefry key:
  the loss within rtol 1e-5, the masters as the engine test of
  tests/test_torch_reference_profile.py holds them (all but 0.1% of the
  elements within atol 1e-5 / rtol 1e-4), except that every element is
  held within two Adam steps (2 x lr 1e-4), not one: the first Adam step
  moves each element by ~lr x sign(grad), and a grad within f32 noise of
  zero takes either sign (the train-mode pipeline's RGB luma and the
  ResNet round differently in XLA and torch); a frozen encoder bit-equal
  to where it started.
- `eval_avhubert_s2s` on a synthetic fairseq checkpoint and dictionary: the
  same GOLD / HYP lines and WER line as the JAX CLI, both run in f32 (the
  CLIs' bf16 casts redirected in this process only; bf16 rounds at
  different places in XLA and eager torch).
- Every new CLI end to end with `--device cpu`, and the pre-training ->
  `cluster_units --features avhubert` -> pre-training round trip. These
  initialise from their own generator and are not held to JAX's numbers.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni_avsr_tpu_torch.bridge import params_from_numpy
from omni_avsr_tpu_torch.cli import train_avhubert_s2s as pcli
from omni_avsr_tpu_torch.utils import prng

LR = 1e-4
TEXTS = ["hello world", "big red dog"]


@pytest.fixture(autouse=True)
def remat_off(monkeypatch):
    """The CLIs' training steps under `OMNI_REMAT=off`: the same values as
    the default "dots" (tests/test_torch_avhubert_family.py), whose
    selective checkpoint costs seconds a step on the CPU."""
    monkeypatch.setenv("OMNI_REMAT", "off")


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _jax_step(head, enc_cfg, dec_cfg, d, freeze, params):
    """The JAX CLI's `train_step` (`omni_avsr_tpu/cli/train_avhubert_s2s.py:
    131-182`), built as that CLI builds it."""
    import optax

    from omni_avsr_tpu.models.avhubert import avhubert_encode
    from omni_avsr_tpu.models.avhubert_s2s import ctc_loss, s2s_cross_entropy, s2s_decoder_forward
    from omni_avsr_tpu.ops.augment import video_pipeline
    from omni_avsr_tpu.train.optim import warmup_cosine_schedule

    schedule = warmup_cosine_schedule(LR, 0.0, 1, 100)
    wd_mask = jax.tree_util.tree_map(lambda _: True, params)
    if freeze:
        wd_mask = {"enc": jax.tree_util.tree_map(lambda _: False, params["enc"]),
                   "head": jax.tree_util.tree_map(lambda _: True, params["head"])}
    tx = optax.chain(optax.clip_by_global_norm(10.0),
                     optax.adamw(schedule, b1=0.9, b2=0.98, weight_decay=0.1, mask=wd_mask))

    def step(params, opt_state, video, audio_feats, video_len, tgt, tgt_len, key):
        def loss_fn(params):
            v = video_pipeline(key, video, video_len, train=True)
            enc = avhubert_encode(params["enc"], enc_cfg, v, audio=audio_feats, lengths=video_len)
            if head == "s2s":
                prev = jnp.concatenate([jnp.full((tgt.shape[0], 1), d.eos, jnp.int32),
                                        tgt[:, :-1]], axis=1)
                logits = s2s_decoder_forward(params["head"], dec_cfg, prev, enc, video_len)
                return s2s_cross_entropy(logits, tgt, d.pad)
            return ctc_loss(params["head"], enc, video_len, tgt, tgt_len, blank_id=d.bos)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        if freeze:
            grads = {**grads, "enc": jax.tree_util.tree_map(jnp.zeros_like, grads["enc"])}
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return tx, step


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
    return out


@pytest.fixture(scope="module")
def jax_trees():
    """The tiny CLI configurations of both packages and one tree of each
    head, made once from a torch generator (`bridge.py`'s builders) and
    handed to both sides as numpy arrays."""
    from omni_avsr_tpu.cli import train_avhubert_s2s as jcli
    from omni_avsr_tpu.config import AVHubertConfig as JCfg
    from omni_avsr_tpu.models.avhubert_s2s import S2SDecoderConfig as JDec
    from omni_avsr_tpu_torch.bridge import init_avhubert, init_ctc_head, init_s2s_decoder

    d = pcli.LetterDictionary()
    assert len(jcli.LetterDictionary()) == len(d)
    enc_cfg, dec_cfg = pcli.model_configs(True, d)
    jenc = JCfg(**{f: getattr(enc_cfg, f) for f in enc_cfg.__dataclass_fields__})
    jdec = JDec(**{f: getattr(dec_cfg, f) for f in dec_cfg.__dataclass_fields__})
    g = torch.Generator().manual_seed(0)
    trees = {"enc": init_avhubert(enc_cfg, g, "cpu"), "s2s": init_s2s_decoder(dec_cfg, g, "cpu"),
             "ctc": init_ctc_head(enc_cfg.encoder_embed_dim, len(d), g, "cpu")}
    return d, enc_cfg, dec_cfg, jenc, jdec, jax.tree_util.tree_map(lambda t: t.numpy(), trees)


@pytest.mark.parametrize("head,modality,freeze", [
    ("s2s", "audiovisual", False), ("ctc", "video", False), ("s2s", "video", True)])
def test_train_step_matches_jax(jax_trees, head, modality, freeze):
    from omni_avsr_tpu_torch.data.audio_features import batch_stacked_fbank

    d, enc_cfg, dec_cfg, jenc, jdec, trees = jax_trees
    jparams = {"enc": trees["enc"], "head": trees[head]}

    rng = np.random.RandomState(1)
    T = 32
    video = rng.randint(0, 255, (2, T, 96, 96, 3)).astype(np.uint8)
    video_len = np.array([32, 25], np.int32)
    audio = (rng.randn(2, T * 640) * 0.1).astype(np.float32)
    afeats = (batch_stacked_fbank(audio, video_len * 640, T) if modality == "audiovisual"
              else None)
    tgt, tgt_len = pcli.make_targets(d, TEXTS, T)
    key_seed = 7

    tx, jstep = _jax_step(head, jenc, jdec, d, freeze, jparams)
    jnew, _, jloss = jax.jit(jstep)(
        jparams, tx.init(jparams), jnp.asarray(video),
        None if afeats is None else jnp.asarray(afeats), jnp.asarray(video_len),
        jnp.asarray(tgt), jnp.asarray(tgt_len),
        jax.random.fold_in(jax.random.PRNGKey(key_seed), 0))

    trainer = pcli.S2STrainer(enc_cfg, dec_cfg, head, params_from_numpy(jparams, "cpu"), LR, 1,
                              freeze, "cpu", blank_id=d.bos, remat="off")
    before = _flat(trainer.masters["enc"])
    loss = trainer.step(_t(video), None if afeats is None else _t(afeats), _t(video_len),
                        _t(tgt), _t(tgt_len), prng.fold_in(prng.PRNGKey(key_seed), 0))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want, got = _flat(jax.device_get(jnew)), _flat(trainer.masters)
    assert got.keys() == want.keys()
    outside = total = 0
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=2 * LR, rtol=0, err_msg=path)
        outside += int((np.abs(got[path] - want[path]) > 1e-5 + 1e-4 * np.abs(want[path])).sum())
        total += want[path].size
    assert outside <= total // 1000, (outside, total)
    if freeze:
        for path, value in _flat(trainer.masters["enc"]).items():
            np.testing.assert_array_equal(value, before[path], err_msg=path)


def _fairseq_files(tmp_path):
    from omni_avsr_tpu_torch.data.synthetic import WORDS, generate_corpus
    from test_eval_avhubert_s2s_cli import _s2s_state_dict

    _, _, test_csv = generate_corpus(str(tmp_path), n_train=1, n_val=1, n_test=2,
                                     min_frames=24, max_frames=32)
    ckpt = str(tmp_path / "s2s.pt")
    torch.save({"model": _s2s_state_dict(vocab=4 + len(set(WORDS)))}, ckpt)
    dict_path = str(tmp_path / "dict.wrd.txt")
    with open(dict_path, "w") as f:
        for w in sorted(set(WORDS)):
            f.write(f"{w.upper()} 1\n")
    return ["--ckpt", ckpt, "--dict", dict_path, "--root-dir", str(tmp_path),
            "--test-file", test_csv, "--encoder-layers", "2", "--encoder-dim", "64",
            "--encoder-heads", "4", "--encoder-ffn-dim", "128", "--decoder-layers", "2",
            "--decoder-embed-dim", "32", "--decoder-ffn-dim", "64", "--decoder-heads", "4"]


@pytest.mark.parametrize("decode", [["--num-beams", "3"], []], ids=["beam3", "greedy"])
def test_eval_prints_what_the_jax_cli_prints(tmp_path, capsys, monkeypatch, decode):
    import omni_avsr_tpu.convert.avhubert_s2s_torch as jconv
    from omni_avsr_tpu.cli import eval_avhubert_s2s as jeval
    from omni_avsr_tpu_torch.cli import eval_avhubert_s2s as peval

    argv = _fairseq_files(tmp_path) + ["--modality", "audiovisual", "--max-len", "6"] + decode
    monkeypatch.setattr(peval, "INFER_DTYPE", torch.float32)
    peval.main(argv + ["--device", "cpu"])
    ours = capsys.readouterr().out
    monkeypatch.setattr(jnp, "bfloat16", jnp.float32)
    monkeypatch.setattr(jconv.convert_avhubert_s2s, "__defaults__", (jnp.float32,))
    jeval.main(argv)
    theirs = capsys.readouterr().out
    assert ours.count("HYP :") == 2 and "WER:" in ours
    assert ours == theirs


def test_cli_refuses_without_a_card(tmp_path):
    from omni_avsr_tpu_torch.cli import pretrain_avhubert

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for main, extra in ((pcli.main, []), (pretrain_avhubert.main, [])):
        with pytest.raises(SystemExit, match="--device cpu"):
            main(["--synthetic", "2", "--exp-dir", str(tmp_path)] + extra)


@pytest.mark.parametrize("head,modality,freeze", [
    ("s2s", "audiovisual", "false"), ("ctc", "video", "true")])
def test_train_cli_runs_on_the_cpu(tmp_path, capsys, head, modality, freeze):
    trainer = pcli.main(["--synthetic", "3", "--head", head, "--modality", modality,
                         "--freeze-encoder", freeze, "--max-epochs", "1", "--max-dec-len", "6",
                         "--exp-dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "epoch 0: loss=" in out
    assert ("WER:" in out) == (head == "s2s")
    assert trainer.opt_state.count >= 1


def test_pretrain_cluster_round_trip_on_the_cpu(tmp_path, capsys):
    """pretrain -> checkpoint in the port's format -> layer-2 dump + k-means
    (.km labels at 25 Hz, one per frame) -> pretrain on those labels; and
    the MFCC units at 100 Hz."""
    from omni_avsr_tpu_torch.cli import cluster_units, pretrain_avhubert
    from omni_avsr_tpu_torch.data.dataset import load_manifest
    from omni_avsr_tpu_torch.train.checkpoint import latest_checkpoint

    exp1 = tmp_path / "it1"
    pretrain_avhubert.main(["--synthetic", "3", "--max-steps", "2", "--exp-dir", str(exp1),
                            "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step 1: loss=" in out and "saved" in out
    ckpt = latest_checkpoint(str(exp1 / "checkpoints"))
    assert ckpt is not None and (exp1 / "config.json").exists()
    data = exp1 / "synthetic_data"
    frames = {os.path.splitext(os.path.basename(e.rel_path))[0]: e.input_length
              for e in load_manifest(str(data / "train.csv"))}
    for features, extra, rate in (("avhubert", ["--layer", "2", "--ckpt", ckpt], 25),
                                  ("mfcc", [], 100)):
        units = tmp_path / f"units_{features}"
        cluster_units.main(["--root-dir", str(data), "--manifest", str(data / "train.csv"),
                            "--out-dir", str(units), "--n-clusters", "4", "--iters", "3",
                            "--features", features, "--device", "cpu"] + extra)
        assert (units / "label_rate.txt").read_text() == str(rate)
        assert np.load(units / "kmeans.npy").shape[0] == 4
        km = {p.stem: p.read_text().split() for p in (units / "labels").glob("*.km")}
        assert km.keys() == frames.keys()
        if features == "avhubert":
            assert {k: len(v) for k, v in km.items()} == frames
            assert all(0 <= int(u) < 4 for v in km.values() for u in v)
    pretrain_avhubert.main(["--synthetic", "3", "--max-steps", "1", "--exp-dir",
                            str(tmp_path / "it2"), "--labels-dir",
                            str(tmp_path / "units_avhubert"), "--device", "cpu"])
    assert "step 1: loss=" in capsys.readouterr().out
