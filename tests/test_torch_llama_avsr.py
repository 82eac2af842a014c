"""The port's Llama-AVSR baseline and fused training forward against the JAX
package, at the tiny flagship widths (bucketed Whisper window), f32 on
both sides (tests/torch_parity.py::jax_in_f32):

  - `single_task_loss` of each modality at every rate combo (rtol 1e-5)
    and its trainable grads (atol 2e-5 / rtol 1e-4, the bar of
    tests/test_torch_train.py);
  - `_fused_train_losses` (`cfg.fused_task_forward`) against the JAX fused
    losses and grads and against the port's unfused ones;
  - `OmniEngine._rate_combos`, one `single_train_step` (augmentation and
    dropout off) and `single_eval_step` against the JAX engine's;
  - `inference_only=True`: no optimizer state, the same decoded tokens;
    `eval_omni` and `eval_llama_avsr` build their engine so;
  - `train_llama_avsr` and `eval_llama_avsr` with `--synthetic --device
    cpu`: the JAX CLIs' printed and logged keys, and in f32 on one tree
    the JAX CLI's WER lines.
"""

import collections
import dataclasses
import json
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omni_avsr_tpu_torch.bridge import params_from_numpy, split_trainable
from omni_avsr_tpu_torch.config import TrainConfig
from omni_avsr_tpu_torch.train.state import cast_trainable, master_weights, merge_params
from tests.test_torch_train import _flat, _grads, _raw_batch, _trim
from tests.torch_parity import (
    jax_in_f32,
    jax_tiny_flagship,
    jax_tiny_params,
    port_model,
    randomize_lora_down,
)

COMBOS = [("audio", 4, None), ("audio", 16, None), ("video", None, 2), ("video", None, 5),
          ("audiovisual", 4, 2), ("audiovisual", 16, 2), ("audiovisual", 4, 5),
          ("audiovisual", 16, 5)]


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny():
    jm = jax_tiny_flagship()
    return jm, jax_tiny_params(jm)


def _processed(jm, seed=0):
    """`_raw_batch` through the JAX package's eval preprocessing, numpy."""
    from omni_avsr_tpu.ops.augment import audio_pipeline, video_pipeline

    raw = _raw_batch(jm.tok, seed)
    proc = dict(raw)
    proc["video"] = np.asarray(video_pipeline(None, raw["video"], raw["video_len"], train=False))
    proc["audio"] = np.asarray(audio_pipeline(None, raw["audio"], raw["audio_len"], train=False))
    return proc


def _port_masters(pm, params):
    trainable, frozen = split_trainable(params, pm.trainable_predicate(), "cpu",
                                        frozen_dtype=torch.float32)
    masters = master_weights(trainable, "cpu")
    return masters, merge_params(cast_trainable(masters, pm.dtype), frozen)


def _check_grads(masters, jgrads):
    want = _flat(jax.device_get(jgrads))
    got = _flat(_grads(masters))
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=2e-5, rtol=1e-4, err_msg=path)


@pytest.mark.parametrize("modality,ra,rv", COMBOS)
def test_single_task_loss_and_grads_match_jax(monkeypatch, tiny, modality, ra, rv):
    from omni_avsr_tpu.train.state import merge_params as jmerge
    from omni_avsr_tpu.train.state import split_params as jsplit

    jax_in_f32(monkeypatch)
    jm, params = tiny
    proc = _processed(jm)
    trim = _trim()
    jt, jf = jsplit(jax.tree_util.tree_map(jnp.asarray, params), jm.trainable_predicate())

    def jloss(t, f, b):  # the frozen tree and batch as arguments: XLA folds no constants
        return jm.single_task_loss(jmerge(t, f), b, modality, ra, rv, trim, train_mode=False)

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(jt, jf, {k: jnp.asarray(v)
                                                             for k, v in proc.items()})

    pm = port_model(jm)
    masters, merged = _port_masters(pm, params)
    tproc = {k: torch.from_numpy(np.array(v)) for k, v in proc.items()}
    feats = pm.task_features(merged, tproc, modality, trim, train_mode=False)
    loss = pm.single_task_loss(merged, tproc, modality, feats, ra, rv)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    _check_grads(masters, jgrads)
    # the adapters of the other tasks take no grad
    lora = _grads(masters)["llm"]["layers"]["lora"]
    for m in ("audio", "video", "audiovisual"):
        assert bool(lora[m]["down_q"]["w"].abs().sum() > 0) == (m == modality)


def test_fused_losses_and_grads_match_jax_and_unfused(monkeypatch, tiny):
    """`fused_task_forward`: the JAX fused losses and grads, and the port's
    unfused ones, in f32 (tighter than the JAX test's 2e-3 in bf16)."""
    from omni_avsr_tpu.models.omni import OmniAVSR as JaxOmni
    from omni_avsr_tpu.train.state import merge_params as jmerge
    from omni_avsr_tpu.train.state import split_params as jsplit

    from omni_avsr_tpu_torch.models.omni import OmniAVSR

    jax_in_f32(monkeypatch)
    jm, params = tiny
    jfused = JaxOmni(dataclasses.replace(jm.cfg, fused_task_forward=True), jm.tok)
    proc = _processed(jm, seed=2)
    trim = _trim()
    jt, jf = jsplit(jax.tree_util.tree_map(jnp.asarray, params), jm.trainable_predicate())

    def jloss(t, f, b):
        losses = jfused.train_losses(jmerge(t, f), b, 4, 2, trim, train_mode=False)
        return (losses["audio"] + losses["video"] + losses["audiovisual"]) / 3.0, losses

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jt, jf, {k: jnp.asarray(v) for k, v in proc.items()})

    unfused = port_model(jm)
    fused = OmniAVSR(dataclasses.replace(unfused.cfg, fused_task_forward=True), unfused.tok,
                     dtype=torch.float32)
    tproc = {k: torch.from_numpy(np.array(v)) for k, v in proc.items()}
    results = {}
    for name, pm in (("fused", fused), ("unfused", unfused)):
        masters, merged = _port_masters(pm, params)
        losses = pm.train_losses(merged, tproc, 4, 2, trim, train_mode=False)
        ((losses["audio"] + losses["video"] + losses["audiovisual"]) / 3.0).backward()
        results[name] = ({m: v.item() for m, v in losses.items()}, masters)
    for m in ("audio", "video", "audiovisual"):
        np.testing.assert_allclose(results["fused"][0][m], float(jlosses[m]), rtol=1e-5)
        np.testing.assert_allclose(results["fused"][0][m], results["unfused"][0][m], rtol=1e-5)
    _check_grads(results["fused"][1], jgrads)
    fused_g, unfused_g = _flat(_grads(results["fused"][1])), _flat(_grads(results["unfused"][1]))
    for path in unfused_g:
        np.testing.assert_allclose(fused_g[path], unfused_g[path], atol=2e-5, rtol=1e-4,
                                   err_msg=path)


@pytest.mark.parametrize("matryoshka", [True, False])
def test_rate_combos_match_jax(tiny, matryoshka):
    from omni_avsr_tpu.config import TrainConfig as JaxTrainConfig
    from omni_avsr_tpu.models.omni import OmniAVSR as JaxOmni
    from omni_avsr_tpu.train.engine import OmniEngine as JaxEngine

    from omni_avsr_tpu_torch.train.engine import OmniEngine

    jm, params = tiny
    if not matryoshka:
        jm = JaxOmni(dataclasses.replace(jm.cfg, is_matryoshka=False,
                                         downsample_ratio_audio=(4,),
                                         downsample_ratio_video=(2,)), jm.tok)
    je = JaxEngine(jm, params, JaxTrainConfig(), inference_only=True)
    pe = OmniEngine(port_model(jm), params_from_numpy(params, "cpu"), TrainConfig(),
                    inference_only=True, device="cpu")
    for m in ("audio", "video", "audiovisual"):
        assert pe._rate_combos(m) == je._rate_combos(m)
    assert len(pe._rate_combos("audiovisual")) == (4 if matryoshka else 1)


def test_single_steps_match_jax(monkeypatch, tiny):
    """One Llama-MTSK `single_train_step` on audiovisual (the mean over its
    four rate combos; augmentation and dropout off, BN on batch statistics
    on both sides): the loss and the AdamW-updated masters; then
    `single_eval_step` on the updated state.

    A first Adam step moves an element by lr * g / (|g| + eps) plus the
    decay: where |g| is within ~100x of eps = 1e-8, the move hangs on f32
    rounding in g (a sum over four rate combos) and two correct steps can
    differ by a fraction of lr. The masters are held to atol 2e-5 wherever
    the JAX step's own move shows |g| > ~99 eps or g = 0, to one step
    elsewhere, and those elements must be under 1% of the tree."""
    import omni_avsr_tpu.train.state as jstate
    from omni_avsr_tpu.config import TrainConfig as JaxTrainConfig
    from omni_avsr_tpu.train.engine import OmniEngine as JaxEngine

    from omni_avsr_tpu_torch.train.engine import OmniEngine

    jax_in_f32(monkeypatch)
    monkeypatch.setattr(jstate.make_train_step, "__defaults__", (jnp.float32,))
    jm, params = tiny
    raw = {**_raw_batch(jm.tok, seed=3), "audio_trim_len": _trim()}
    je = JaxEngine(jm, jax.tree_util.tree_map(jnp.asarray, params), JaxTrainConfig(lr=1e-3),
                   augment=False, seed=5)
    pe = OmniEngine(port_model(jm), params_from_numpy(params, "cpu"), TrainConfig(lr=1e-3),
                    augment=False, seed=5, device="cpu")
    jloss = float(je.single_train_step(dict(raw), "audiovisual"))
    loss = pe.single_train_step(dict(raw), "audiovisual")
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    assert pe.state.step == 1
    want, got = _flat(jax.device_get(je.state.trainable)), _flat(pe.state.trainable)
    init = _flat(params)
    assert got.keys() == want.keys()
    lr, wd = 1e-3, TrainConfig().weight_decay
    n_soft = n_all = 0
    for path in want:
        r = np.abs(want[path] - init[path] * (1 - lr * wd)) / lr  # |g| / (|g| + eps)
        soft = (r > 1e-4) & (r < 0.99)
        np.testing.assert_allclose(got[path][~soft], want[path][~soft], atol=2e-5, err_msg=path)
        np.testing.assert_array_less(np.abs(got[path] - want[path]), lr)
        n_soft += int(soft.sum())
        n_all += soft.size
    assert n_soft < 1e-2 * n_all, (n_soft, n_all)
    ev = pe.single_eval_step(dict(raw), "audio")
    np.testing.assert_allclose(ev.item(), float(je.single_eval_step(dict(raw), "audio")),
                               rtol=1e-5)


def test_inference_only_engine(tiny):
    """No optimizer and no grads; f32 trainable leaves; the same decoded
    tokens as a training engine's; a training step refuses."""
    from omni_avsr_tpu_torch.train.engine import OmniEngine
    from omni_avsr_tpu_torch.train.state import tree_leaves

    jm, params = tiny
    pm = port_model(jm)
    full = OmniEngine(pm, params_from_numpy(params, "cpu"), TrainConfig(), device="cpu")
    lean = OmniEngine(pm, params_from_numpy(params, "cpu"), TrainConfig(), inference_only=True,
                      device="cpu")
    assert lean.tx is None and lean.state.opt_state is None
    assert full.state.opt_state is not None
    leaves = list(tree_leaves(lean.state.trainable))
    assert leaves and all(v.dtype == torch.float32 and not v.requires_grad for v in leaves)
    raw = _raw_batch(jm.tok, seed=4)
    batch = {k: v for k, v in raw.items() if k not in ("tokens", "labels")}
    batch["audio_trim_len"] = _trim()
    for m, ra, rv in (("audio", 4, None), ("audiovisual", 4, 2)):
        got = lean.decode_batch(lean.merged_params(), batch, m, ra, rv, num_beams=3, max_new=6)
        assert got == full.decode_batch(full.merged_params(), batch, m, ra, rv, num_beams=3,
                                        max_new=6)
    with pytest.raises(RuntimeError, match="inference_only"):
        lean.single_train_step({**raw, "audio_trim_len": _trim()}, "audio")


# ------------------------------------------------------------------ the CLIs

class FakeJaxEngine:
    """Stands in for the JAX `OmniEngine` in the JAX baseline CLIs: only the
    CLI's loop, printing and logging run."""

    def __init__(self, model, params, train_cfg, steps_per_epoch, **kw):
        self.cfg = model.cfg
        self.state = collections.namedtuple("State", "step trainable opt_state")(
            0, {"w": np.zeros(1, np.float32)}, None)

    def _rate_combos(self, modality):
        from omni_avsr_tpu.train.engine import OmniEngine

        return OmniEngine._rate_combos(self, modality)

    def single_train_step(self, batch, modality):
        self.state = self.state._replace(step=self.state.step + 1)
        return 1.0

    def single_eval_step(self, batch, modality):
        return 1.0

    def merged_params(self):
        return {}

    def decode_batch(self, params, batch, task, ra=None, rv=None):
        return ["hello"] * len(batch["gold_text"])


def _records(path):
    return [json.loads(line) for line in open(path)]


@pytest.mark.parametrize("modality", ["audio", "video"])
def test_train_llama_avsr_keys_match_jax(monkeypatch, tmp_path, capsys, modality):
    """`train_llama_avsr.main` on the CPU: the printed epoch, average and
    `wer/...` lines and the metrics log's records carry the JAX CLI's keys;
    the checkpoint and the average are written."""
    import omni_avsr_tpu.cli.train_llama_avsr as jax_train
    from omni_avsr_tpu_torch.cli import train_llama_avsr

    argv = ["--synthetic", "4", "--max-epochs", "1", "--modality", modality,
            "--whisper-input-mode", "bucket", "--num-beams", "2", "--max-dec-tokens", "4"]
    exp = tmp_path / "port"
    train_llama_avsr.main(argv + ["--device", "cpu", "--exp-dir", str(exp)])
    ours_out = capsys.readouterr().out
    assert (exp / "omni" / "checkpoints" / "step_00000001.pt").exists()
    assert (exp / "omni" / "model_avg_4" / "step_00000001.pt").exists()

    monkeypatch.setattr(jax_train, "OmniEngine", FakeJaxEngine)
    monkeypatch.setattr(jax_train, "build_params", lambda args, model: {})
    monkeypatch.setattr(jax_train, "save_checkpoint", lambda *a, **k: None)
    monkeypatch.setattr(jax_train, "average_last_n", lambda d, state, n: state.trainable)
    jexp = tmp_path / "jax"
    jax_train.main(argv + ["--exp-dir", str(jexp)])
    theirs_out = capsys.readouterr().out

    def keys(out):
        return [re.sub(r"[-0-9.]+", "#", line.split(" -> ")[0]) for line in out.splitlines()
                if line.startswith(("epoch ", "averaged ", "wer/"))]

    assert keys(ours_out) == keys(theirs_out)
    assert sum(line.startswith("wer/") for line in ours_out.splitlines()) == 2
    ours = _records(exp / "omni" / "metrics.jsonl")
    theirs = _records(jexp / "omni" / "metrics.jsonl")
    assert [list(r) for r in ours] == [list(r) for r in theirs]


EVAL_ARGV = ["--synthetic", "3", "--whisper-input-mode", "bucket", "--num-beams", "2",
             "--max-dec-tokens", "4", "--print-hyp", "false"]


@pytest.fixture(scope="module")
def baseline_tree():
    """The numpy f32 tree of the JAX audiovisual baseline model of the eval
    CLI (LoRA downs randomised), made once: a one-modality model's tree is
    its subset (`_subtree`)."""
    import omni_avsr_tpu.cli.eval_llama_avsr as jax_eval

    with pytest.MonkeyPatch.context() as mp:
        jax_in_f32(mp)
        jm = jax_eval.build_model(jax_eval.parse_args(EVAL_ARGV + ["--modality", "audiovisual"]))
        init = jax.jit(lambda k: jm.init_params(k, frozen_dtype=jnp.float32))
        return randomize_lora_down(jax.device_get(init(jax.random.PRNGKey(0))))


def _subtree(jm, tree):
    """The leaves of `tree` that the JAX model `jm` initialises; their
    paths, shapes and dtypes are checked against its init's abstract tree."""
    want = jax.eval_shape(lambda k: jm.init_params(k, frozen_dtype=jnp.float32),
                          jax.random.PRNGKey(0))
    sub = {k: tree[k] for k in want}
    spec = lambda t: jax.tree_util.tree_map(lambda v: (v.shape, np.dtype(v.dtype)), t)  # noqa: E731
    assert spec(sub) == spec(want)
    return sub


@pytest.mark.parametrize("flags", [
    ["--modality", "audio", "--quantize-decode", "int8", "--test-batch-size", "2"],
    ["--modality", "audiovisual", "--downsample-ratio-test-matry", "5", "16"],
], ids=["audio-int8", "av-matry"])
def test_eval_llama_avsr_wer_matches_jax(monkeypatch, tmp_path, capsys, baseline_tree, flags):
    """`eval_llama_avsr.main` of both packages, f32 on both sides, on one
    numpy tree: the same `WER ... (e/n)` lines. The port builds its engine
    with `inference_only=True`, as the JAX CLI does."""
    import omni_avsr_tpu.cli.eval_llama_avsr as jax_eval
    import omni_avsr_tpu_torch.cli.eval_llama_avsr as port_eval
    from omni_avsr_tpu_torch.models.omni import OmniAVSR
    from omni_avsr_tpu_torch.train.engine import OmniEngine

    jax_in_f32(monkeypatch)
    monkeypatch.setenv("OMNI_BEAM_ATTN", "kernel")
    argv = EVAL_ARGV + flags
    jm = jax_eval.build_model(jax_eval.parse_args(argv))
    tree = _subtree(jm, baseline_tree)
    monkeypatch.setattr(jax_eval, "build_params", lambda args, model: jax.tree_util.tree_map(
        jnp.asarray, tree))
    jax_eval.main(argv + ["--exp-dir", str(tmp_path / "jax")])
    theirs = [line for line in capsys.readouterr().out.splitlines() if line.startswith("WER")]

    built = []

    def engine(*a, **kw):
        built.append(kw)
        return OmniEngine(*a, **kw)

    build_model = port_eval.build_model
    monkeypatch.setattr(port_eval, "build_model", lambda args: OmniAVSR(
        build_model(args).cfg, build_model(args).tok, dtype=torch.float32))
    monkeypatch.setattr(port_eval, "build_params",
                        lambda args, model, device: params_from_numpy(tree, device))
    monkeypatch.setattr(port_eval, "OmniEngine", engine)
    port_eval.main(argv + ["--device", "cpu", "--exp-dir", str(tmp_path / "port")])
    ours = [line for line in capsys.readouterr().out.splitlines() if line.startswith("WER")]
    assert ours == theirs and ours
    assert built and built[0]["inference_only"] is True


def test_eval_omni_builds_an_inference_only_engine(monkeypatch, tmp_path):
    import omni_avsr_tpu_torch.cli.eval_omni as eval_omni
    from omni_avsr_tpu_torch.train.engine import OmniEngine

    engines = []

    def engine(*a, **kw):
        engines.append(OmniEngine(*a, **kw))
        return engines[-1]

    monkeypatch.setattr(eval_omni, "OmniEngine", engine)
    eval_omni.main(["--synthetic", "1", "--device", "cpu", "--exp-dir", str(tmp_path),
                    "--test-specific-modality", "audio", "--test-specific-ratio", "4",
                    "--whisper-input-mode", "bucket", "--num-beams", "2", "--max-dec-tokens",
                    "2", "--print-hyp", "false"])
    assert len(engines) == 1 and engines[0].state.opt_state is None and engines[0].tx is None
