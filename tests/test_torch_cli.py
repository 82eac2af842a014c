"""The port's `eval_omni` and `train_omni` CLIs against the JAX package's:

  - run on the CPU (`--device cpu`) with `--synthetic`, each prints and
    logs the same result keys as the JAX CLI with the same flags (the JAX
    side's engine and parameter builder stubbed out, so that only its CLI
    code, which makes the keys, runs);
  - a resumed training run continues at the right epoch and keeps the
    checkpoints and the average;
  - one evaluation sweep decodes through both engines' `decode_batch` in
    f32 from the same converted reference `.pth` and the same corpus: the
    hypotheses and the WER are identical (the JAX side on
    `OMNI_BEAM_ATTN=kernel`, `tests/torch_parity.py::jax_in_f32`);
  - without a card and without `--device cpu` the CLI exits non-zero, and
    each flag of unported work raises.
"""

import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import jax_in_f32, twin_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--num-beams", "2", "--max-dec-tokens", "4"]


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """The CLIs' tiny models run many small ops: two intra-op threads keep
    them from contending with the suite's other worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class FakeJaxEngine:
    """Stands in for the JAX `OmniEngine` in the JAX CLI: no model runs,
    so only the CLI's loop, logging and result keys are exercised."""

    def __init__(self, model, params, train_cfg, steps_per_epoch, **kw):
        self.state = collections.namedtuple("State", "step trainable opt_state")(
            0, {"w": np.zeros(1, np.float32)}, None)

    def schedule(self, step):
        return 1e-3

    def train_step(self, batch):
        self.state = self.state._replace(step=self.state.step + 1)
        return 1.0

    def eval_step(self, batch):
        return 1.0, {}

    def merged_params(self):
        return {}

    def decode_batch(self, params, batch, task, ra=None, rv=None):
        return ["hello"] * len(batch["gold_text"])


def _stub_jax_cli(monkeypatch, module):
    monkeypatch.setattr(module, "OmniEngine", FakeJaxEngine)
    monkeypatch.setattr(module, "build_params", lambda args, model: {})


@pytest.mark.parametrize("flags", [
    [],
    ["--task-to-test", "vsr"],
    ["--test-specific-modality", "audiovisual", "--test-specific-ratio", "16", "5",
     "--use-shared-lora-task-specific", "true"],
    ["--modality", "audio", "--test-batch-size", "2", "--score-bleu", "true"],
], ids=["grid", "vsr", "specific-shared-lora", "audio-bleu"])
def test_eval_keys_match_jax(monkeypatch, tmp_path, capsys, flags):
    """`eval_omni.main` on the CPU: the WER results' keys, in order, and the
    `--output-json` file's keys equal the JAX CLI's; every WER is a finite
    ratio. The bucketed Whisper window keeps the CPU run short (the sweep
    below decodes at the default 30 s window)."""
    import omni_avsr_tpu.cli.eval_omni as jax_eval
    from omni_avsr_tpu_torch.cli import eval_omni

    argv = ["--synthetic", "2", "--print-hyp", "false", "--whisper-input-mode", "bucket"] + TINY
    argv += flags
    ours = eval_omni.main(argv + ["--device", "cpu", "--exp-dir", str(tmp_path / "port"),
                                  "--output-json", str(tmp_path / "port.json")])
    out = capsys.readouterr().out
    _stub_jax_cli(monkeypatch, jax_eval)
    theirs = jax_eval.main(argv + ["--exp-dir", str(tmp_path / "jax"),
                                   "--output-json", str(tmp_path / "jax.json")])
    assert list(ours) == list(theirs) and ours
    assert (list(json.load(open(tmp_path / "port.json")))
            == list(json.load(open(tmp_path / "jax.json"))))
    assert all(np.isfinite(v) and v >= 0 for v in ours.values())
    if "--score-bleu" in flags:
        assert "BLEU4 = " in out


def _records(path):
    return [json.loads(line) for line in open(path)]


def test_train_keys_and_resume_match_jax(monkeypatch, tmp_path, capsys):
    """`train_omni.main` on the CPU: one epoch with the auto-test, then a
    resumed run to two epochs. The metrics log has the JAX CLI's records
    (the same keys in the same order), the auto-test the same WER keys,
    and the resumed run starts at epoch 1 and keeps both checkpoints and
    the average."""
    import omni_avsr_tpu.cli.train_omni as jax_train
    from omni_avsr_tpu_torch.cli import train_omni

    exp = tmp_path / "port"
    argv = ["--synthetic", "4", "--max-epochs", "1", "--downsample-ratio-audio", "4",
            "--downsample-ratio-video", "2", "--whisper-input-mode", "bucket"] + TINY
    train_omni.main(argv + ["--device", "cpu", "--exp-dir", str(exp)])
    first = capsys.readouterr().out
    assert "resumed" not in first
    train_omni.main(argv + ["--max-epochs", "2", "--device", "cpu", "--exp-dir", str(exp),
                            "--auto-test", "false"])
    resumed = capsys.readouterr().out
    ckpts = sorted(os.listdir(exp / "omni" / "checkpoints"))
    assert "at epoch 1" in resumed and "epoch 1:" in resumed and "epoch 0:" not in resumed
    assert ckpts == ["step_00000001.pt", "step_00000002.pt"]
    # each run writes its average at its last step, as the JAX CLI does
    assert sorted(os.listdir(exp / "omni" / "model_avg_4")) == ckpts
    ours = _records(exp / "omni" / "metrics.jsonl")

    monkeypatch.setattr(jax_train, "save_checkpoint", lambda *a, **k: None)
    monkeypatch.setattr(jax_train, "average_last_n", lambda d, state, n: state.trainable)
    _stub_jax_cli(monkeypatch, jax_train)
    jexp = tmp_path / "jax"
    jax_train.main(argv + ["--exp-dir", str(jexp)])
    theirs = _records(jexp / "omni" / "metrics.jsonl")
    # the JAX run's records are those of the first port run
    assert [list(r) for r in ours[:len(theirs)]] == [list(r) for r in theirs]
    wer = [k for r in ours for k in r if k.startswith("wer/")]
    assert wer == [k for r in theirs for k in r if k.startswith("wer/")] and len(wer) == 5
    assert [r["step"] for r in ours if "epoch" in r] == [1, 2]


@pytest.fixture(scope="module")
def sweep_setup(tmp_path_factory):
    """The tiny CLI model of both packages, one reference-layout `.pth`
    converted by each in f32, and a corpus of 3 test clips."""
    from omni_avsr_tpu.cli.common import build_model as jax_build_model
    from omni_avsr_tpu.cli.eval_omni import parse_args as jax_parse
    from omni_avsr_tpu.data.synthetic import generate_corpus
    from tests.test_converters import _reference_state_dict

    root = tmp_path_factory.mktemp("sweep")
    jm = jax_build_model(jax_parse(["--tiny", "true", "--num-beams", "3", "--max-dec-tokens", "6"]))
    torch.manual_seed(0)
    path = str(root / "omni.pth")
    torch.save({"state_dict": _reference_state_dict(jm.cfg)}, path)
    _, _, test = generate_corpus(str(root), n_train=1, n_val=1, n_test=3, seed=4)
    return jm, path, root, test


def test_eval_sweep_decodes_like_jax(monkeypatch, sweep_setup):
    """One sweep (each task at its first rates, batches of 3 clips) through
    both engines' `decode_batch`, f32 on both sides, from the same
    converted `.pth`: identical hypotheses and WER."""
    from omni_avsr_tpu.config import DataConfig as JaxDataConfig, TrainConfig as JaxTrainConfig
    from omni_avsr_tpu.convert.omni_ckpt import convert_omni_checkpoint as jax_convert
    from omni_avsr_tpu.data.datamodule import DataModule as JaxDataModule
    from omni_avsr_tpu.train.engine import OmniEngine as JaxEngine
    from omni_avsr_tpu.utils.metrics import WerAccumulator as JaxWer
    import omni_avsr_tpu_torch.config as port_config
    from omni_avsr_tpu_torch.config import DataConfig, TrainConfig
    from omni_avsr_tpu_torch.convert.omni_ckpt import convert_omni_checkpoint, load_torch_checkpoint
    from omni_avsr_tpu_torch.data.datamodule import DataModule
    from omni_avsr_tpu_torch.data.tokenizer import synthetic_tokenizer
    from omni_avsr_tpu_torch.models.omni import OmniAVSR
    from omni_avsr_tpu_torch.train.engine import OmniEngine
    from omni_avsr_tpu_torch.utils.metrics import WerAccumulator

    jm, path, root, test = sweep_setup
    jax_in_f32(monkeypatch)
    monkeypatch.setenv("OMNI_BEAM_ATTN", "kernel")
    sd = load_torch_checkpoint(path)
    pm = OmniAVSR(twin_config(jm.cfg, port_config), synthetic_tokenizer("llama"),
                  dtype=torch.float32)
    je = JaxEngine(jm, jax.tree_util.tree_map(jnp.asarray,
                                              jax_convert(sd, jm.cfg, frozen_dtype=jnp.float32)),
                   JaxTrainConfig(), 1.0, inference_only=True)
    pe = OmniEngine(pm, convert_omni_checkpoint(sd, pm.cfg, frozen_dtype=torch.float32),
                    TrainConfig(), 1.0, device="cpu")
    jparams, params = je.merged_params(), pe.merged_params()
    kw = dict(root_dir=str(root), test_file=test, num_workers=2)
    n_words = 0
    for task, ra, rv in (("audio", 4, None), ("video", None, 2), ("audiovisual", 4, 2)):
        acc, jacc = WerAccumulator(), JaxWer()
        dm = DataModule(DataConfig(**kw), pm.tok, modality=task)
        jdm = JaxDataModule(JaxDataConfig(**kw), jm.tok, modality=task)
        for batch, jbatch in zip(dm.test_batches(3), jdm.test_batches(3)):
            hyps = pe.decode_batch(params, batch, task, ra, rv)
            assert hyps == je.decode_batch(jparams, jbatch, task, ra, rv)
            assert len(hyps) == 3 and all(hyps)
            n_words += sum(len(h.split()) for h in hyps)
            for ref, hyp in zip(batch["gold_text"], hyps):
                acc.update(ref, hyp)
                jacc.update(ref, hyp)
        assert acc.wer == jacc.wer and acc.total_length > 0
    assert n_words > 9


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a CUDA device")
def test_cli_refuses_to_run_without_a_card(tmp_path):
    """No CUDA device and no `--device cpu`: a non-zero exit with a message,
    before any work."""
    from omni_avsr_tpu_torch.cli import (
        eval_llama_avsr,
        eval_omni,
        serve_http,
        train_llama_avsr,
        train_omni,
        verify_parity,
    )

    argv = ["--synthetic", "1", "--exp-dir", str(tmp_path / "inproc")]
    for cli, args in ((eval_omni, argv), (train_omni, argv), (eval_llama_avsr, argv),
                      (train_llama_avsr, argv), (verify_parity, argv),
                      (serve_http, ["--synthetic", "--port", "0"])):
        with pytest.raises(SystemExit) as exc:
            cli.main(args)
        assert "--device cpu" in str(exc.value.code), cli
    proc = subprocess.run(
        [sys.executable, "-m", "omni_avsr_tpu_torch.cli.eval_omni", "--synthetic", "1",
         "--exp-dir", str(tmp_path / "sub")], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 1 and "--device cpu" in proc.stderr, proc.stderr
    assert not (tmp_path / "inproc").exists() and not (tmp_path / "sub").exists()


@pytest.mark.parametrize("flag", [
    ["--num-nodes", "2"], ["--mesh-tp", "2"], ["--mesh-pp", "2"], ["--mesh-ep", "2"],
    ["--fsdp", "true"], ["--sequence-parallel", "true"], ["--node-rank", "1"],
    ["--coordinator-address", "10.0.0.1:1234"],
])
def test_unported_flags_raise(tmp_path, flag):
    """The parallel flags, refused until the port had parallelism, now reach
    the rank start-up (`parallel/distributed.py::resolve_rendezvous`) and
    the mesh (`cli/common.py::setup_parallelism`). In one process each one
    that asks for more ranks raises the JAX package's message before any
    work; `--node-rank` alone starts nothing; the coordinator's address
    becomes the rendezvous (resolved here, nothing is contacted)."""
    from omni_avsr_tpu_torch.cli import train_llama_avsr, train_omni
    from omni_avsr_tpu_torch.cli.common import check_args, setup_parallelism
    from omni_avsr_tpu_torch.parallel.distributed import resolve_rendezvous

    for cli in (train_omni, train_llama_avsr):
        args = cli.parse_args(["--synthetic", "1", "--device", "cpu",
                               "--exp-dir", str(tmp_path)] + flag)
        check_args(args)
        name = flag[0]
        if name == "--num-nodes":
            with pytest.raises(ValueError, match="--coordinator-address"):
                resolve_rendezvous(args.num_nodes, args.coordinator_address, args.node_rank,
                                   environ={})
            continue
        rv = resolve_rendezvous(args.num_nodes, args.coordinator_address, args.node_rank,
                                environ={})
        if name == "--coordinator-address":
            assert rv == ("tcp://10.0.0.1:1234", 1, 0, 0)
            continue
        assert rv is None
        if name in ("--mesh-tp", "--mesh-pp", "--mesh-ep"):
            with pytest.raises(AssertionError, match="1 devices not divisible by tp\\*pp\\*ep=2"):
                setup_parallelism(args)
        elif name == "--sequence-parallel":
            with pytest.raises(AssertionError, match="--sequence-parallel needs --mesh-tp > 1"):
                setup_parallelism(args)
        elif name == "--fsdp":
            with pytest.raises(ValueError, match="process group"):
                setup_parallelism(args)
        else:
            assert setup_parallelism(args)[0] is None
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("cli_name", ["eval_omni", "train_omni", "eval_llama_avsr",
                                      "train_llama_avsr"])
def test_compilation_cache_dir_accepted(tmp_path, capsys, cli_name):
    """The JAX package's `--compilation-cache-dir` is accepted (a command
    line that JAX runs runs on the port) and prints its one line."""
    import importlib

    from omni_avsr_tpu_torch.cli.common import check_args

    cli = importlib.import_module(f"omni_avsr_tpu_torch.cli.{cli_name}")
    args = cli.parse_args(["--synthetic", "1", "--device", "cpu", "--exp-dir", str(tmp_path),
                           "--compilation-cache-dir", str(tmp_path / "cache")])
    assert check_args(args) == torch.device("cpu")
    out = capsys.readouterr().out
    assert out.count("\n") == 1 and "compiles no XLA program" in out
    assert "build/torch_kernels/" in out and not os.listdir(tmp_path)
