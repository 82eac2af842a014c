"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs and parameters are made with numpy from a seed and handed to both
the JAX reference and the port. Parameters come from the JAX package's own
initialiser in f32 (`init_params(key, frozen_dtype=jnp.float32)`), carried
across leaf for leaf by `omni_avsr_tpu_torch.bridge.params_from_numpy`.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

# Every worker process of the suite collects this module. Two torch
# intra-op threads a process keep the workers from oversubscribing the
# host's cores: idle OpenMP threads spin, and with a thread per core in
# each of 6 workers the parity files took twice the wall time.
torch.set_num_threads(2)


def randomize_lora_down(tree, seed: int = 7, std: float = 0.05):
    """The initialisers zero every LoRA down projection, which would leave
    the adapter math untested: give them small random values, in place."""
    rng = np.random.RandomState(seed)

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                if k in ("down_q", "down_v"):
                    v["w"] = (rng.randn(*v["w"].shape) * std).astype(np.float32)
                else:
                    walk(v)

    walk(tree)
    return tree


def jax_tiny_flagship(bucket: bool = True):
    """`__graft_entry__._flagship(tiny=True)`, with the serving bench's
    bucketed Whisper window."""
    from __graft_entry__ import _flagship
    from omni_avsr_tpu.models.omni import OmniAVSR

    model = _flagship(tiny=True)
    if bucket:
        model = OmniAVSR(dataclasses.replace(model.cfg, whisper_input_mode="bucket"), model.tok)
    return model


def jax_moe_flagship(routing: str = "balanced", experts: int = 4):
    """The tiny JAX flagship with its LLM's MLPs replaced by `experts`
    experts (`omni_avsr_tpu/cli/common.py:185-188`)."""
    from omni_avsr_tpu.models.omni import OmniAVSR

    jm = jax_tiny_flagship()
    llm = dataclasses.replace(jm.cfg.llm, moe_experts=experts, moe_routing=routing)
    return OmniAVSR(dataclasses.replace(jm.cfg, llm=llm), jm.tok)


def jax_tiny_params(model, seed: int = 0):
    """numpy f32 parameter tree of the JAX model, LoRA downs randomised."""
    init = jax.jit(lambda k: model.init_params(k, frozen_dtype=jnp.float32))
    params = jax.device_get(init(jax.random.PRNGKey(seed)))
    return randomize_lora_down(params)


def clips(lengths=(40, 33, 48), seed: int = 0):
    """Synthetic requests: 16 kHz audio (640 samples per frame) plus raw
    96x96 RGB mouth frames, one per length."""
    rng = np.random.RandomState(seed)
    return [{"audio": (rng.randn(n * 640) * 0.1).astype(np.float32),
             "video": rng.randint(0, 255, (n, 96, 96, 3), dtype=np.uint8)} for n in lengths]


def jax_in_f32(monkeypatch):
    """Run the JAX package's serving path in f32 end to end: its modules
    name `jnp.bfloat16` for the activations, the trainable-leaf cast and
    (as a keyword default of beam search and greedy decoding) the decode
    KV cache. The package is unchanged;
    only this test process's names are redirected, and restored after."""
    import omni_avsr_tpu.decode.decoding as jdec

    monkeypatch.setattr(jnp, "bfloat16", jnp.float32)
    for fn in (jdec.beam_search, jdec.greedy_decode):
        monkeypatch.setitem(fn.__kwdefaults__, "cache_dtype", jnp.float32)



def jax_conv_kernel(monkeypatch):
    """Route the JAX package's `fused_conv` (which takes its XLA reference
    off the TPU) through its Pallas kernel B7, `conv2d_fused_pallas`, in
    interpret mode, as `OMNI_CONV_KERNEL=1` routes it on the TPU. The
    operands are rounded to bf16 first with the true bf16 type, which is
    what the kernel does itself: under `jax_in_f32` its own cast names the
    redirected `jnp.bfloat16` and would keep them in f32. Only this test
    process's name is redirected, and restored after."""
    import omni_avsr_tpu.ops.conv_block as jcb

    kernel = jcb.conv2d_fused_pallas
    bf16 = jnp.dtype("bfloat16")

    def fused_conv(x, w, stride=1, pad=1, scale=None, bias=None, prelu_a=None, residual=None):
        x = x.astype(bf16).astype(x.dtype)
        w = w.astype(bf16).astype(w.dtype)
        return kernel(x, w, stride, pad, scale, bias, prelu_a, residual, interpret=True)

    monkeypatch.setattr(jcb, "fused_conv", fused_conv)


def twin_config(cfg, module):
    """The config dataclass of the same name in `module` (the port's or the
    JAX package's config module), rebuilt field for field from `cfg`,
    nested configs too; a field only one side has keeps its default."""
    cls = getattr(module, type(cfg).__name__)
    kw = {}
    for f in dataclasses.fields(cls):
        if hasattr(cfg, f.name):
            v = getattr(cfg, f.name)
            kw[f.name] = twin_config(v, module) if dataclasses.is_dataclass(v) else v
    return cls(**kw)


def port_model(jax_model, dtype=None):
    """The port's OmniAVSR for a JAX one: the same config and a fresh
    synthetic tokenizer of the same family and vocabulary (its prompt ids
    come out the same: words get ids in order of first use)."""
    import torch

    import omni_avsr_tpu_torch.config as port_cfg
    from omni_avsr_tpu_torch.data.tokenizer import synthetic_tokenizer
    from omni_avsr_tpu_torch.models.omni import OmniAVSR

    tok = synthetic_tokenizer(jax_model.tok.family, base_vocab=jax_model.tok.vocab_size - 7)
    return OmniAVSR(twin_config(jax_model.cfg, port_cfg), tok, dtype=dtype or torch.float32)


def jax_tiny_qwen(bucket: bool = True, **cfg_changes):
    """The tiny JAX flagship with a Qwen-2.5-style LLM: family "qwen" (no
    BOS, pad = EOS), q/k/v bias, rope theta 1e6 without scaling, rms eps
    1e-6, an untied lm_head, and 6 query heads over 2 kv heads (group 3);
    `cfg_changes` replace fields of the Omni config (compression, projectors)."""
    from omni_avsr_tpu.config import LLMConfig, LoRAConfig
    from omni_avsr_tpu.data.tokenizer import synthetic_tokenizer
    from omni_avsr_tpu.models.omni import OmniAVSR

    base = jax_tiny_flagship(bucket)
    tok = synthetic_tokenizer("qwen", base_vocab=505)
    llm = LLMConfig(
        family="qwen", vocab_size=tok.vocab_size, hidden_size=96, intermediate_size=192,
        num_layers=2, num_heads=6, num_kv_heads=2, head_dim=16, rms_norm_eps=1e-6,
        rope_theta=1000000.0, rope_scaling_factor=None, tie_word_embeddings=False,
        attention_bias=True,
        lora=LoRAConfig(rank_divisor=8, alpha=4, task_specific=True, v_out_divisor=3),
    )
    return OmniAVSR(dataclasses.replace(base.cfg, llm=llm, **cfg_changes), tok)


# Compression and projector variants of the tiny flagship (Omni config fields)
PROJECTOR_VARIANTS = {
    "stack": dict(compression_mode="stack"),
    "stack-single-rate": dict(compression_mode="stack", is_matryoshka=False,
                              downsample_ratio_audio=(4,), downsample_ratio_video=(2,)),
    "single-matry": dict(is_single_matry_projector=True),
    "single-matry-no-ln": dict(is_single_matry_projector=True,
                               remove_layernorm_from_projector=True),
}


def projector_variant(name: str, base_params):
    """(JAX model, numpy tree) of a variant: the tiny flagship's config with
    the variant's fields, and `base_params` (the tiny flagship's tree) with
    the variant's projectors made by the JAX package's
    `init_matry_projectors`, as its `init_params` makes them."""
    from omni_avsr_tpu.models.omni import OmniAVSR
    from omni_avsr_tpu.models.projector import init_matry_projectors

    base = jax_tiny_flagship()
    jm = OmniAVSR(dataclasses.replace(base.cfg, **PROJECTOR_VARIANTS[name]), base.tok)
    cfg = jm.cfg
    params = dict(base_params)
    towers = (("audio_proj", cfg.audio_rates, cfg.whisper.hidden_size),
              ("video_proj", cfg.video_rates, cfg.avhubert.encoder_embed_dim))
    for i, (key, rates, dim) in enumerate(towers):
        params[key] = jax.device_get(init_matry_projectors(
            jax.random.PRNGKey(10 + i), rates, dim, cfg.projector_intermediate_size,
            cfg.llm.hidden_size, cfg.compression_mode, cfg.is_matryoshka,
            cfg.is_single_matry_projector, cfg.remove_layernorm_from_projector))
    return jm, params


def _leaves(node, prefix=""):
    for k, v in node.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


def check_projector_init(name: str, pm, params) -> None:
    """The port's `bridge.init_params` makes the projectors of `params` (a
    variant's JAX tree): the same leaves and shapes, f32, LayerNorm where
    the JAX decision table puts one, stacked inputs enc_dim x rate."""
    import torch

    from omni_avsr_tpu_torch.bridge import init_params

    ours = init_params(pm.cfg, torch.Generator().manual_seed(0), "cpu")
    for key in ("audio_proj", "video_proj"):
        got = {p: tuple(v.shape) for p, v in _leaves(ours[key])}
        want = {p: tuple(v.shape) for p, v in _leaves(params[key])}
        assert got == want, (key, got, want)
        assert all(v.dtype == torch.float32 for _, v in _leaves(ours[key]))
    single = "single" in params["audio_proj"]
    assert single == name.startswith(("single", "stack-single"))
    with_ln = "ln" in params["audio_proj"].get("single", {})
    assert with_ln == (name in ("single-matry", "stack-single-rate"))
    if name.startswith("stack"):
        proj = params["audio_proj"]["single"] if single else params["audio_proj"]["per_rate"]["r4"]
        assert proj["fc1"]["w"].shape[0] == 4 * pm.cfg.whisper.hidden_size


def check_prefix_and_tokens(monkeypatch, jm, pm, params) -> None:
    """The masked audiovisual prefix within atol 2e-4 / rtol 1e-3 and the
    beam-15 int8 tokens identical, port against JAX (f32 on both sides,
    `OMNI_BEAM_ATTN=kernel` on the JAX side)."""
    import torch

    from omni_avsr_tpu.ops.augment import audio_pipeline as japp, video_pipeline as jvpp
    from omni_avsr_tpu.serve import Transcriber as JaxTranscriber
    from omni_avsr_tpu_torch.bridge import params_from_numpy
    from omni_avsr_tpu_torch.ops.augment import audio_pipeline, video_pipeline
    from omni_avsr_tpu_torch.serve import Transcriber, pad_batch

    jax_in_f32(monkeypatch)
    monkeypatch.setenv("OMNI_BEAM_ATTN", "kernel")
    items = clips((40, 33, 48), seed=6)
    batch, trim = pad_batch(items, "audiovisual")
    jparams = jax.tree_util.tree_map(jnp.asarray, params)

    def jfn(p, b):
        b = dict(b)
        b["video"] = jvpp(None, b["video"], b["video_len"], train=False)
        b["audio"] = japp(None, b["audio"], b["audio_len"], train=False)
        return jm.infer_prefix_masked(p, b, "audiovisual", 4, 2, trim)

    jemb, jvalid = jax.jit(jfn)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["video"] = video_pipeline(tb["video"], tb["video_len"])
    tb["audio"] = audio_pipeline(tb["audio"], tb["audio_len"])
    temb, tvalid = pm.infer_prefix_masked(params_from_numpy(params, "cpu"), tb, "audiovisual",
                                          4, 2, trim)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), atol=2e-4, rtol=1e-3)

    jt = JaxTranscriber(jm, jparams, num_beams=15, quantize="int8")
    jdecode = jt.engine._decode_fn("audiovisual", 4, 2, trim, 15, 32)
    jax_ids = np.asarray(jdecode(jt.params, {k: jnp.asarray(v) for k, v in batch.items()},
                                 jax.random.PRNGKey(0)))
    pt = Transcriber(pm, params_from_numpy(params, "cpu"), num_beams=15, quantize="int8",
                     device="cpu")
    ids = pt.decode_ids(batch, "audiovisual", 4, 2, trim, 15).numpy()
    np.testing.assert_array_equal(ids, jax_ids)
    assert (ids != pm.tok.pad_id).any()


def transcriber_pair(multiple: int, num_beams: int):
    """(JAX Transcriber, port Transcriber) of the tiny flagship (bucketed
    window) on one numpy tree, int8, at `video_pad_multiple`; the JAX one
    built in f32."""
    import pytest

    from omni_avsr_tpu.serve import Transcriber as JaxTranscriber
    from omni_avsr_tpu_torch.bridge import params_from_numpy
    from omni_avsr_tpu_torch.serve import Transcriber

    jm = jax_tiny_flagship()
    params = jax_tiny_params(jm)
    with pytest.MonkeyPatch.context() as mp:
        jax_in_f32(mp)
        jt = JaxTranscriber(jm, jax.tree_util.tree_map(jnp.asarray, params),
                            num_beams=num_beams, quantize="int8", video_pad_multiple=multiple)
    pt = Transcriber(port_model(jm), params_from_numpy(params, "cpu"), num_beams=num_beams,
                     quantize="int8", device="cpu", video_pad_multiple=multiple)
    return jt, pt


def check_transcribe(monkeypatch, jt, pt, streams: str, modality) -> None:
    """`transcribe` of one request whose audio (37 frames' worth) outlasts
    its video (20 frames) gives the JAX method's string: with both streams
    the audio pads to the padded video's length, whatever the modality."""
    monkeypatch.setenv("OMNI_BEAM_ATTN", "kernel")
    jax_in_f32(monkeypatch)
    item = {"audio": clips((37,), seed=8)[0]["audio"], "video": clips((20,), seed=9)[0]["video"]}
    kw = dict(audio=item["audio"] if streams != "video" else None,
              video=item["video"] if streams != "audio" else None, modality=modality)
    want = jt.transcribe(**kw)
    assert pt.transcribe(**kw) == want
    assert want and 1 <= pt.last_decode_steps <= 32
