"""The port's checkpoint converters against the JAX package's: the same
reference-layout state dicts (`tests/test_converters.py::_reference_state_dict`,
built with the reference's key layout at tiny dims) through both
packages' converters give the same tree, equal leaf by leaf (tolerance:
none), in f32 and in bf16. Covered: Whisper, AV-HuBERT (the weight-norm
fold, LoRA present or fresh), Llama and Qwen (q/k/v biases, an untied
head, per-modality and shared LoRA, fresh LoRA), per-rate and single
projectors with and without their LayerNorm, `Transcriber.from_pretrained`
and the CLIs' `build_params` for each `--*-path` flag.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import omni_avsr_tpu_torch.config as port_config
from omni_avsr_tpu.config import LLMConfig, LoRAConfig
from omni_avsr_tpu.convert.avhubert_torch import convert_avhubert as jax_avhubert
from omni_avsr_tpu.convert.llm_torch import convert_llm as jax_llm
from omni_avsr_tpu.convert.omni_ckpt import convert_omni_checkpoint as jax_omni
from omni_avsr_tpu.convert.omni_ckpt import convert_projectors as jax_projectors
from omni_avsr_tpu_torch.convert.avhubert_torch import convert_avhubert
from omni_avsr_tpu_torch.convert.llm_torch import convert_llm
from omni_avsr_tpu_torch.convert.omni_ckpt import (
    convert_omni_checkpoint,
    convert_projectors,
    load_torch_checkpoint,
)
from tests.test_converters import _reference_state_dict, _tiny_cfg
from tests.torch_parity import twin_config


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        elif isinstance(v, torch.Tensor):
            out[path] = (str(v.dtype).replace("torch.", ""), v.float().numpy())
        else:
            v = jnp.asarray(v)
            out[path] = (str(v.dtype), np.asarray(v.astype(jnp.float32)))
    return out


def assert_same_tree(ours, theirs):
    a, b = _flat(ours), _flat(theirs)
    assert sorted(a) == sorted(b)
    for path in a:
        assert a[path][0] == b[path][0], (path, a[path][0], b[path][0])
        assert a[path][1].shape == b[path][1].shape, path
        np.testing.assert_array_equal(a[path][1], b[path][1], err_msg=path)


def _qwen_cfg(shared: bool = False):
    """The tiny config with a Qwen-style LLM: q/k/v biases, an untied head,
    3 query heads per kv head; shared adapters beside the task ones."""
    cfg = _tiny_cfg()
    llm = LLMConfig(family="qwen", vocab_size=254, hidden_size=48, intermediate_size=96,
                    num_layers=2, num_heads=6, num_kv_heads=2, head_dim=8,
                    rope_scaling_factor=None, tie_word_embeddings=False, attention_bias=True,
                    lora=LoRAConfig(rank_divisor=8, alpha=4, task_specific=True, shared=shared,
                                    v_out_divisor=3))
    return dataclasses.replace(cfg, llm=llm)


def _with_qwen_keys(sd, cfg):
    g = torch.Generator().manual_seed(1)
    l = cfg.llm
    for i in range(l.num_layers):
        p = f"llm.model.layers.{i}.self_attn"
        for name, n in (("q_proj", l.q_dim), ("k_proj", l.kv_dim), ("v_proj", l.kv_dim)):
            sd[f"{p}.{name}.bias"] = torch.randn(n, generator=g)
    sd["llm.lm_head.weight"] = torch.randn(l.vocab_size, l.hidden_size, generator=g) * 0.02
    return sd


def _single_projectors(sd, cfg, with_ln: bool):
    """The state dict with one Sequential per modality in place of the
    per-rate ModuleList (with its LayerNorm at index 3 when `with_ln`)."""
    sd = {k: v for k, v in sd.items() if not k.startswith(("audio_proj.", "video_proj."))}
    g = torch.Generator().manual_seed(2)
    inter, h = cfg.projector_intermediate_size, cfg.llm.hidden_size
    for name, dim in (("audio_proj", cfg.whisper.hidden_size),
                      ("video_proj", cfg.avhubert.encoder_embed_dim)):
        sd[f"{name}.0.weight"] = torch.randn(inter, dim, generator=g)
        sd[f"{name}.0.bias"] = torch.randn(inter, generator=g)
        sd[f"{name}.2.weight"] = torch.randn(h, inter, generator=g)
        sd[f"{name}.2.bias"] = torch.randn(h, generator=g)
        if with_ln:
            sd[f"{name}.3.weight"] = torch.rand(h, generator=g) + 0.5
            sd[f"{name}.3.bias"] = torch.randn(h, generator=g)
    return sd


CASES = {
    "llama": (_tiny_cfg, lambda sd, cfg: sd),
    "llama-bf16-weights": (_tiny_cfg, lambda sd, cfg: {k: v.to(torch.bfloat16)
                                                      for k, v in sd.items()}),
    "qwen-bias-untied": (_qwen_cfg, _with_qwen_keys),
    "qwen-shared-lora": (lambda: _qwen_cfg(shared=True), _with_qwen_keys),
    "single-projector-ln": (lambda: dataclasses.replace(_tiny_cfg(), is_single_matry_projector=True),
                            lambda sd, cfg: _single_projectors(sd, cfg, True)),
    "single-projector-no-ln": (lambda: dataclasses.replace(_tiny_cfg(), is_single_matry_projector=True,
                                                           remove_layernorm_from_projector=True),
                               lambda sd, cfg: _single_projectors(sd, cfg, False)),
    "lightning-prefix": (_tiny_cfg, lambda sd, cfg: {f"model.{k}": v for k, v in sd.items()}),
}


@pytest.mark.parametrize("frozen", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_omni_checkpoint_matches_jax(case, frozen):
    """A whole trained Omni checkpoint: every leaf equal, frozen leaves in
    the chosen dtype, projectors and LoRA in f32."""
    make_cfg, edit = CASES[case]
    cfg = make_cfg()
    sd = edit(_reference_state_dict(cfg), cfg)
    theirs = jax_omni(sd, cfg, frozen_dtype=getattr(jnp, frozen))
    ours = convert_omni_checkpoint(sd, twin_config(cfg, port_config),
                                   frozen_dtype=getattr(torch, frozen))
    assert_same_tree(ours, theirs)
    flat = _flat(ours)
    assert flat["llm.layers.lora.audio.up_v.w"][0] == "float32"
    assert flat["llm.layers.attn.q.w"][0] == frozen
    if case.startswith("qwen"):
        assert "llm.layers.attn.q.b" in flat and "llm.lm_head.w" in flat
    if case == "qwen-shared-lora":
        assert "llm.layers.lora_shared.down_q.w" in flat
    if case.startswith("single"):
        assert ("audio_proj.single.ln.scale" in flat) == (case == "single-projector-ln")


def test_base_checkpoints_get_fresh_lora():
    """Base LLM and AV-HuBERT checkpoints (no adapter keys): the fresh
    adapters (zero downs, seeded uniform ups) equal the JAX package's."""
    cfg = _tiny_cfg()
    sd = {k: v for k, v in _reference_state_dict(cfg).items() if "lora_" not in k}
    llm = {k[len("llm."):]: v for k, v in sd.items() if k.startswith("llm.")}
    assert_same_tree(convert_llm(llm, twin_config(cfg.llm, port_config)), jax_llm(llm, cfg.llm))
    shared = dataclasses.replace(cfg.llm, lora=dataclasses.replace(cfg.llm.lora, shared=True,
                                                                   task_specific=True))
    assert_same_tree(convert_llm(llm, twin_config(shared, port_config)), jax_llm(llm, shared))
    flat = dataclasses.replace(cfg.llm, lora=dataclasses.replace(cfg.llm.lora, task_specific=False))
    assert_same_tree(convert_llm(llm, twin_config(flat, port_config)), jax_llm(llm, flat))
    av = {k[len("video_encoder."):]: v for k, v in sd.items() if k.startswith("video_encoder.")}
    ours = convert_avhubert(av, twin_config(cfg.avhubert, port_config))
    assert_same_tree(ours, jax_avhubert(av, cfg.avhubert))
    assert float(ours["layers"]["lora"]["down_q"]["w"].abs().max()) == 0.0


def test_projector_ln_detection():
    sd = {"audio_proj.0.weight": torch.randn(8, 4), "audio_proj.0.bias": torch.zeros(8),
          "audio_proj.2.weight": torch.randn(6, 8), "audio_proj.2.bias": torch.zeros(6),
          "audio_proj.3.weight": torch.ones(6), "audio_proj.3.bias": torch.zeros(6)}
    ours = convert_projectors(sd, "audio_proj", (4,))
    assert_same_tree(ours, jax_projectors(sd, "audio_proj", (4,)))
    assert "ln" in ours["single"]


def test_load_torch_checkpoint(tmp_path):
    """Lightning (`state_dict`) and fairseq (`model`) wrappers unwrap to the
    flat state dict."""
    sd = {"a.weight": torch.randn(3, 2)}
    for wrap in ({"state_dict": sd}, {"model": sd, "cfg": {}}, sd):
        path = str(tmp_path / "ckpt.pth")
        torch.save(wrap, path)
        got = load_torch_checkpoint(path)
        assert list(got) == ["a.weight"] and torch.equal(got["a.weight"], sd["a.weight"])


def _cli_args(extra):
    from omni_avsr_tpu.cli.eval_omni import parse_args as jax_parse
    from omni_avsr_tpu_torch.cli.eval_omni import parse_args

    base = ["--tiny", "true", "--seed", "3"] + extra
    return parse_args(base + ["--device", "cpu"]), jax_parse(base)


@pytest.fixture(scope="module")
def checkpoint_files(tmp_path_factory):
    """The tiny CLI model's reference state dict, saved whole (a trained
    Omni .pth) and as the three base checkpoints the `--*-path` flags read."""
    from omni_avsr_tpu.cli.common import build_model as jax_build_model

    root = tmp_path_factory.mktemp("ckpts")
    args, jargs = _cli_args([])
    jm = jax_build_model(jargs)
    sd = _reference_state_dict(jm.cfg)
    files = {"omni": root / "omni.pth", "whisper": root / "whisper.bin",
             "avhubert": root / "avhubert.pt", "llm": root / "llm.bin"}
    torch.save({"state_dict": sd}, files["omni"])
    torch.save({f"model.encoder.{k[len('audio_encoder.'):]}": v for k, v in sd.items()
                if k.startswith("audio_encoder.")}, files["whisper"])
    torch.save({"model": {k[len("video_encoder."):]: v for k, v in sd.items()
                          if k.startswith("video_encoder.")}}, files["avhubert"])
    torch.save({k[len("llm."):]: v for k, v in sd.items() if k.startswith("llm.")}, files["llm"])
    return {k: str(v) for k, v in files.items()}


@pytest.mark.parametrize("flag,subtree", [
    ("--pretrained-model-path", None),
    ("--whisper-path", "whisper"),
    ("--pretrain-avhubert-enc-video-path", "avhubert"),
    ("--llm-path", "llm"),
])
def test_build_params_matches_jax(monkeypatch, checkpoint_files, flag, subtree):
    """`build_params` of each path flag: the converted tree, or the
    converted subtree beside the random rest, equals the JAX CLI's, leaf by
    leaf in bf16. (The JAX side's random rest is not compared: its
    initialiser is left out, as the two packages draw different numbers.)"""
    from omni_avsr_tpu.cli.common import build_model as jax_build_model
    from omni_avsr_tpu.cli.common import build_params as jax_build_params
    from omni_avsr_tpu.models.omni import OmniAVSR as JaxOmni
    from omni_avsr_tpu_torch.cli.common import build_model, build_params

    key = {"--pretrained-model-path": "omni", "--whisper-path": "whisper",
           "--pretrain-avhubert-enc-video-path": "avhubert", "--llm-path": "llm"}[flag]
    args, jargs = _cli_args([flag, checkpoint_files[key]])
    ours = build_params(args, build_model(args), torch.device("cpu"))
    monkeypatch.setattr(JaxOmni, "init_params", lambda self, key, **kw: {})
    theirs = jax_build_params(jargs, jax_build_model(jargs))
    if subtree is None:
        assert_same_tree(ours, theirs)
    else:
        assert sorted(ours) == ["audio_proj", "avhubert", "llm", "video_proj", "whisper"]
        assert list(theirs) == [subtree]
        assert_same_tree(ours[subtree], theirs[subtree])


def test_build_params_merges_port_checkpoint(tmp_path):
    """`--pretrained-model-path` naming a directory of the port's
    checkpoints: its newest trainable tree is merged over the base weights."""
    from omni_avsr_tpu_torch.cli.common import build_model, build_params
    from omni_avsr_tpu_torch.train.checkpoint import save_checkpoint
    from omni_avsr_tpu_torch.train.state import TrainState, split_params

    args, _ = _cli_args([])
    model = build_model(args)
    base = build_params(args, model, torch.device("cpu"))
    trainable, _ = split_params(base, model.trainable_predicate())
    trained = _flat(trainable)
    bumped = _bump(trainable)
    save_checkpoint(str(tmp_path), 1, TrainState(1, trainable, None))
    save_checkpoint(str(tmp_path), 7, TrainState(7, bumped, None))
    args, _ = _cli_args(["--pretrained-model-path", str(tmp_path)])
    merged = _flat(build_params(args, model, torch.device("cpu")))
    for path, (_, value) in _flat(bumped).items():
        np.testing.assert_array_equal(merged[path][1], value)
        assert not np.array_equal(value, trained[path][1])
    assert merged["llm.layers.attn.q.w"][0] == "bfloat16"


def _bump(tree):
    return {k: _bump(v) if isinstance(v, dict) else v.float() + 1.0 for k, v in tree.items()}


def test_from_pretrained(tmp_path, checkpoint_files):
    """`Transcriber.from_pretrained` on a reference .pth gives the converted
    tree (in the serving dtype); on a directory of the port's checkpoints
    it needs base weights and merges the trained leaves over them."""
    from omni_avsr_tpu_torch.cli.common import build_model
    from omni_avsr_tpu_torch.serve import Transcriber
    from omni_avsr_tpu_torch.train.checkpoint import save_checkpoint
    from omni_avsr_tpu_torch.train.state import TrainState, split_params

    args, _ = _cli_args([])
    model = build_model(args)
    t = Transcriber.from_pretrained(checkpoint_files["omni"], tokenizer=model.tok, cfg=model.cfg,
                                    device="cpu")
    want = convert_omni_checkpoint(load_torch_checkpoint(checkpoint_files["omni"]), model.cfg)
    flat, got = _flat(want), _flat(t.params)
    assert sorted(flat) == sorted(got)
    np.testing.assert_array_equal(got["llm.layers.attn.q.w"][1], flat["llm.layers.attn.q.w"][1])
    np.testing.assert_array_equal(got["audio_proj.per_rate.r4.fc1.w"][1],
                                  torch.from_numpy(flat["audio_proj.per_rate.r4.fc1.w"][1])
                                  .to(torch.bfloat16).float().numpy())

    trainable, _ = split_params(want, model.trainable_predicate())
    save_checkpoint(str(tmp_path), 3, TrainState(3, _bump(trainable), None))
    with pytest.raises(ValueError, match="base_params"):
        Transcriber.from_pretrained(str(tmp_path), tokenizer=model.tok, cfg=model.cfg,
                                    device="cpu")
    t = Transcriber.from_pretrained(str(tmp_path), tokenizer=model.tok, cfg=model.cfg,
                                    base_params=want, device="cpu")
    np.testing.assert_array_equal(
        _flat(t.params)["llm.layers.lora.video.up_q.w"][1],
        torch.from_numpy(flat["llm.layers.lora.video.up_q.w"][1] + 1.0)
        .to(torch.bfloat16).float().numpy())
