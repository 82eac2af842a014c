"""The port's `verify_parity` against the JAX package's:

  - `--synthetic` on one f32 tree (both CLIs' `build_params` handed the
    same numpy tree, `tests/torch_parity.py::jax_in_f32`): the same report
    keys, settings, statuses and WER rows as the JAX run of the same argv,
    plus the port's `profile` record;
  - the whole grid in three modes on the CPU: eight rows, none missing,
    every mode's columns, exit 1 (random weights fail BASELINE.md);
  - `--convert-only` on a reference-layout state dict (as
    tests/test_torch_convert.py builds one) gives the JAX census;
  - `--golden-clip` on a raw clip (`.npy` frames and a sibling wav, the
    centered detector): the report's `golden_clip` has the JAX keys, and
    `golden_transcripts` gives the JAX function's transcripts on one f32
    tree.
"""

import json
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import jax_in_f32, randomize_lora_down

EVAL = ["--synthetic", "2", "--num-beams", "2", "--max-dec-tokens", "4", "--whisper-input-mode",
        "bucket", "--print-hyp", "false"]


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_report_matches_jax(monkeypatch, tmp_path, capsys):
    import omni_avsr_tpu.cli.eval_omni as jax_eval
    from omni_avsr_tpu.cli.verify_parity import main as jax_main

    import omni_avsr_tpu_torch.cli.eval_omni as port_eval
    from omni_avsr_tpu_torch.bridge import params_from_numpy
    from omni_avsr_tpu_torch.cli.verify_parity import main as port_main
    from omni_avsr_tpu_torch.models.omni import OmniAVSR

    jax_in_f32(monkeypatch)
    monkeypatch.setenv("OMNI_BEAM_ATTN", "kernel")
    eval_argv = EVAL + ["--test-specific-modality", "audio", "--test-specific-ratio", "4"]
    jm = jax_eval.build_model(jax_eval.parse_args(eval_argv))
    init = jax.jit(lambda k: jm.init_params(k, frozen_dtype=jnp.float32))
    tree = randomize_lora_down(jax.device_get(init(jax.random.PRNGKey(0))))
    monkeypatch.setattr(jax_eval, "build_params", lambda args, model: jax.tree_util.tree_map(
        jnp.asarray, tree))
    build_model = port_eval.build_model
    monkeypatch.setattr(port_eval, "build_model", lambda args: OmniAVSR(
        build_model(args).cfg, build_model(args).tok, dtype=torch.float32))
    monkeypatch.setattr(port_eval, "build_params",
                        lambda args, model, device: params_from_numpy(tree, device))

    head = ["--modes", "bf16,int8", "--profile", "none"]
    assert jax_main(head + ["--output-json", str(tmp_path / "jax.json")] + eval_argv
                    + ["--exp-dir", str(tmp_path / "jax")]) == 1
    theirs = json.load(open(tmp_path / "jax.json"))
    assert port_main(head + ["--output-json", str(tmp_path / "port.json")] + eval_argv
                     + ["--device", "cpu", "--exp-dir", str(tmp_path / "port")]) == 1
    ours = json.load(open(tmp_path / "port.json"))
    assert list(ours) == list(theirs) + ["profile"]
    assert ours["profile"]["requested"] == "none"
    # no profile: the defaults and the explicit OMNI_BEAM_ATTN=kernel
    assert set(ours["profile"]["reference_pins_not_held"]) == {
        "OMNI_PRNG=threefry", "OMNI_BN_STATS=twopass", "OMNI_BEAM_SELECT=grid",
        "OMNI_BEAM_ATTN=xla", "OMNI_REMAT=off"}
    assert ours["rows"] == theirs["rows"]
    assert [r["status"] for r in ours["rows"]] == ["FAIL"] + ["MISSING"] * 7
    for key in ("modes", "avg_reference", "avg_ours", "worst_abs_delta", "passed"):
        assert ours[key] == theirs[key], key
    # the printed tables agree line for line
    out = capsys.readouterr().out
    tables = [block.split("wrote")[0] for block in out.split("=== parity vs BASELINE.md")[1:]]
    assert len(tables) == 2 and tables[0] == tables[1]


def test_full_grid_three_modes(tmp_path, capsys):
    """The port alone, `--modes bf16,int8,int4` at `--synthetic 2` on the
    CPU: all eight settings measured in every mode, exit 1, and all eight
    pins of the reference profile held, each with its port argument,
    without a change to the process's environment."""
    import os

    from omni_avsr_tpu_torch.cli.verify_parity import BASELINE_WER, main
    from omni_avsr_tpu_torch.utils.profiles import REFERENCE_PROFILE

    env_before = {k: v for k, v in os.environ.items() if k.startswith("OMNI_")}
    out_json = tmp_path / "parity.json"
    rc = main(["--modes", "bf16,int8,int4", "--output-json", str(out_json)] + EVAL
              + ["--device", "cpu", "--exp-dir", str(tmp_path / "eval")])
    assert rc == 1
    assert {k: v for k, v in os.environ.items() if k.startswith("OMNI_")} == env_before
    report = json.load(open(out_json))
    assert report["modes"] == ["bf16", "int8", "int4"] and report["passed"] is False
    assert [r["setting"] for r in report["rows"]] == [
        f"{t} (a={a}, v={v})" for t, a, v in BASELINE_WER["lrs3"]]
    for row in report["rows"]:
        assert row["status"] == "FAIL" and np.isfinite(row["ours"])
        for mode in ("int8", "int4"):
            assert np.isfinite(row[mode]) and np.isfinite(row[f"{mode}_vs_bf16"])
    assert report["worst_abs_delta"] is not None
    assert report["profile"]["requested"] == "reference"
    assert set(report["profile"]["reference_pins_held"]) == {
        f"{k}={v}" for k, v in REFERENCE_PROFILE.items()}
    assert report["profile"]["reference_pins_not_held"] == {}
    assert all(report["profile"]["reference_pins_held"].values())
    assert "8 of 8 reference pins held" in capsys.readouterr().out


def _census(out: str) -> dict:
    return json.loads(out[out.index("{"):out.rindex("}") + 1])


def test_convert_only_census_matches_jax(monkeypatch, tmp_path, capsys):
    from omni_avsr_tpu.cli.common import build_model as jax_build_model
    from omni_avsr_tpu.cli.eval_omni import parse_args as jax_parse
    from omni_avsr_tpu.cli.verify_parity import main as jax_main
    from omni_avsr_tpu.models.omni import OmniAVSR as JaxOmni

    from omni_avsr_tpu_torch.cli.verify_parity import main
    from tests.test_converters import _reference_state_dict

    argv = ["--tiny", "true", "--seed", "3"]
    path = tmp_path / "omni.pth"
    torch.save({"state_dict": _reference_state_dict(jax_build_model(jax_parse(argv)).cfg)}, path)
    argv = ["--convert-only", "--profile", "none", "--pretrained-model-path", str(path)] + argv
    assert main(argv + ["--device", "cpu"]) == 0
    ours_out = capsys.readouterr().out
    # the JAX census reads only the paths and shapes of its model's init
    # tree: their abstract values, without the op-by-op initialisation
    init = JaxOmni.init_params
    monkeypatch.setattr(JaxOmni, "init_params", lambda self, key, **kw: jax.eval_shape(
        lambda k: init(self, k, **kw), key))
    assert jax_main(argv) == 0
    theirs_out = capsys.readouterr().out
    ours, theirs = _census(ours_out), _census(theirs_out)
    assert set(ours) == set(theirs)
    for key in ("leaves", "parameters"):
        assert ours[key] == theirs[key] > 0, key
    for key in ("missing_vs_init", "extra_vs_init", "shape_mismatches"):
        assert ours[key] == [] and theirs[key] == [], key

    def last(out):
        return re.sub(r"\s+", " ", out.strip().splitlines()[-1])

    assert last(ours_out) == last(theirs_out) and last(ours_out).startswith("conversion OK")


def _golden_clip(tmp_path):
    """A raw clip: 20 frames of 120x120 RGB as `.npy`, with a sibling wav."""
    from omni_avsr_tpu_torch.data.synthetic import _write_wav

    rng = np.random.RandomState(0)
    clip = tmp_path / "golden.npy"
    np.save(clip, rng.randint(0, 256, (20, 120, 120, 3), dtype=np.uint8))
    _write_wav(str(tmp_path / "golden.wav"), (rng.randn(20 * 640) * 0.1).astype(np.float32))
    return str(clip)


def test_golden_clip_is_not_ported(tmp_path):
    """The name dates from when the port refused `--golden-clip`: the flag
    now runs, and the report carries the JAX package's `golden_clip` record."""
    from omni_avsr_tpu_torch.cli.verify_parity import main

    out_json = tmp_path / "parity.json"
    rc = main(["--golden-clip", _golden_clip(tmp_path), "--modes", "bf16,int8",
               "--output-json", str(out_json), "--device", "cpu", "--exp-dir",
               str(tmp_path / "eval"), "--test-specific-modality", "audio",
               "--test-specific-ratio", "4"] + EVAL)
    assert rc == 1  # random weights fail BASELINE.md
    golden = json.load(open(out_json))["golden_clip"]
    assert list(golden) == ["modality", "transcripts"]
    assert golden["modality"] == "audiovisual"  # the sibling wav
    assert list(golden["transcripts"]) == ["bf16", "int8"]
    assert all(isinstance(t, str) for t in golden["transcripts"].values())


def test_golden_clip_matches_jax(monkeypatch, tmp_path):
    import omni_avsr_tpu.cli.common as jax_common
    import omni_avsr_tpu.cli.eval_omni as jax_eval
    from omni_avsr_tpu.cli.verify_parity import golden_transcripts as jax_golden

    import omni_avsr_tpu_torch.cli.common as port_common
    from omni_avsr_tpu_torch.bridge import params_from_numpy
    from omni_avsr_tpu_torch.cli.verify_parity import golden_transcripts
    from omni_avsr_tpu_torch.models.omni import OmniAVSR

    jax_in_f32(monkeypatch)
    monkeypatch.setenv("OMNI_BEAM_ATTN", "kernel")
    eval_argv = EVAL + ["--exp-dir", str(tmp_path / "eval")]
    jm = jax_eval.build_model(jax_eval.parse_args(eval_argv))
    init = jax.jit(lambda k: jm.init_params(k, frozen_dtype=jnp.float32))
    tree = randomize_lora_down(jax.device_get(init(jax.random.PRNGKey(0))))
    monkeypatch.setattr(jax_common, "build_params", lambda args, model: jax.tree_util.tree_map(
        jnp.asarray, tree))
    build_model = port_common.build_model
    monkeypatch.setattr(port_common, "build_model", lambda args: OmniAVSR(
        build_model(args).cfg, build_model(args).tok, dtype=torch.float32))
    monkeypatch.setattr(port_common, "build_params",
                        lambda args, model, device: params_from_numpy(tree, device))

    clip = _golden_clip(tmp_path)
    theirs = jax_golden(clip, None, eval_argv, ["bf16", "int8"])
    ours = golden_transcripts(clip, None, eval_argv + ["--device", "cpu"], ["bf16", "int8"])
    assert ours == theirs
    assert ours["modality"] == "audiovisual" and list(ours["transcripts"]) == ["bf16", "int8"]
