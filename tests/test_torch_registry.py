"""The port's model registry against the JAX package's: every
`LLM_REGISTRY` entry and its LoRA V divisor, the tower sizes, the model
constructor (`models/omni.py::registry_model`) against the configuration the
JAX `Transcriber.from_pretrained` builds, the parameter tree
`bridge.init_params` makes for every registry model (shapes and dtypes,
on the meta device), the synthetic tokenizer of both families, rope of
each family, Whisper-base and Whisper-small through the port's encoder,
and AV-HuBERT-Base (post-LN), which both packages refuse; every registry
model's head size is one that the beam-decode kernel B1 takes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import omni_avsr_tpu.config as jcfg
import omni_avsr_tpu_torch.config as pcfg
from omni_avsr_tpu_torch.bridge import init_params, params_from_numpy
from omni_avsr_tpu_torch.data.tokenizer import synthetic_tokenizer
from omni_avsr_tpu_torch.models.omni import registry_model
from tests.test_torch_serving import _assert_same_config
from tests.torch_parity import twin_config

NAMES = list(jcfg.LLM_REGISTRY)


def test_registry_names_match_jax():
    assert list(pcfg.LLM_REGISTRY) == NAMES
    assert len(NAMES) == 9
    assert pcfg.QWEN_V_DIVISOR == jcfg.QWEN_V_DIVISOR


@pytest.mark.parametrize("name", NAMES)
def test_registry_entry_matches_jax(name):
    """Field for field, with and without LoRA and at another vocabulary;
    the V divisor the reference hard-codes per model too."""
    assert pcfg.default_v_divisor(name) == jcfg.default_v_divisor(name)
    v = pcfg.default_v_divisor(name)
    _assert_same_config(pcfg.LLM_REGISTRY[name](), jcfg.LLM_REGISTRY[name]())
    ours = pcfg.LLM_REGISTRY[name](lora=pcfg.LoRAConfig(task_specific=True, v_out_divisor=v),
                                   vocab_size=1000)
    ref = jcfg.LLM_REGISTRY[name](lora=jcfg.LoRAConfig(task_specific=True, v_out_divisor=v),
                                  vocab_size=1000)
    _assert_same_config(ours, ref)


@pytest.mark.parametrize("name", NAMES)
def test_registry_entry_decodes_through_b1(name):
    """On the card the decode takes B1 where B1 takes the head size and the
    reorder route where it does not (`decode_route`, as the JAX package
    routes it on the TPU): every registry model takes B1, the CLIs' tiny
    test model (head size 16) the reorder route, and on the CPU both keep
    the ancestor route (B1's plain version)."""
    from omni_avsr_tpu_torch.cli.common import tiny_dims
    from omni_avsr_tpu_torch.decode.decoding import decode_route
    from omni_avsr_tpu_torch.ops.beam_attention import kernel_supported

    head_dim = pcfg.LLM_REGISTRY[name]().head_dim
    assert kernel_supported(head_dim) and decode_route(None, head_dim, "cuda") == "kernel"
    tiny = tiny_dims()[2]["head_dim"]
    assert not kernel_supported(tiny) and decode_route(None, tiny, "cuda") == "xla"
    assert decode_route(None, tiny, "cpu") == decode_route(None, head_dim, "cpu") == "kernel"
    assert decode_route("xla", head_dim, "cuda") == "xla"


@pytest.mark.parametrize("ctor", ["whisper_medium_en", "whisper_small_en", "whisper_base_en",
                                  "avhubert_large", "avhubert_base"])
def test_tower_config_matches_jax(ctor):
    _assert_same_config(getattr(pcfg, ctor)(), getattr(jcfg, ctor)())


def _jax_from_pretrained_model(monkeypatch, name, jtok):
    """The model the JAX `Transcriber.from_pretrained` builds when given a
    tokenizer and no config: its checkpoint reader is replaced, and the
    Transcriber it returns only records the model."""
    import omni_avsr_tpu.convert.omni_ckpt as ckpt
    from omni_avsr_tpu.serve import Transcriber as JaxTranscriber

    class Capture(JaxTranscriber):
        def __init__(self, model, params, **kw):
            self.model = model

    monkeypatch.setattr(ckpt, "load_torch_checkpoint", lambda path: {})
    monkeypatch.setattr(ckpt, "convert_omni_checkpoint", lambda state, cfg: {})
    return Capture.from_pretrained("model.pth", llm_model=name, tokenizer=jtok).model


@pytest.mark.parametrize("name", NAMES)
def test_registry_model_matches_jax_from_pretrained(monkeypatch, name):
    from omni_avsr_tpu.data.tokenizer import synthetic_tokenizer as jax_tokenizer

    family = "qwen" if "Qwen" in name else "llama"
    ref = _jax_from_pretrained_model(monkeypatch, name, jax_tokenizer(family, base_vocab=1000))
    ours = registry_model(name, synthetic_tokenizer(family, base_vocab=1000))
    _assert_same_config(ours.cfg, ref.cfg)
    assert ours.cfg.llm.vocab_size == 1007
    for m in ours.prompt_ids:
        np.testing.assert_array_equal(ours.prompt_ids[m], ref.prompt_ids[m])
    assert registry_model(name, synthetic_tokenizer(family), whisper_input_mode="bucket"
                          ).cfg.whisper_input_mode == "bucket"
    with pytest.raises(ValueError, match="tokenizer"):
        registry_model(name, synthetic_tokenizer("llama" if family == "qwen" else "qwen"))


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_shapes(v, path))
        else:
            out[path] = (tuple(v.shape), np.dtype(v.dtype).name if not isinstance(v, torch.Tensor)
                         else str(v.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_init_params_tree_matches_jax(name):
    """`bridge.init_params` of the full-width registry model (on the meta
    device: shapes only) has the JAX initialiser's tree, shapes and dtypes
    (bf16 frozen, f32 projectors), the q/k/v biases of Qwen and the untied
    lm_head included; the ResNet's conv weights stay bf16 in the port."""
    from omni_avsr_tpu.data.tokenizer import synthetic_tokenizer as jax_tokenizer
    from omni_avsr_tpu.models.omni import OmniAVSR as JaxOmni

    family = "qwen" if "Qwen" in name else "llama"
    ours = registry_model(name, synthetic_tokenizer(family, base_vocab=1000))
    ref = JaxOmni(twin_config(ours.cfg, jcfg), jax_tokenizer(family, base_vocab=1000))
    want = _shapes(jax.eval_shape(lambda k: ref.init_params(k), jax.random.PRNGKey(0)))
    got = _shapes(init_params(ours.cfg, torch.Generator().manual_seed(0), "meta"))
    # the JAX ResNet's conv weights come out f32 whatever the frozen dtype
    # (a bf16 draw times a numpy f64 scale promotes): shapes only there
    convs = {k for k in want if k.startswith("avhubert.video_frontend") and k.endswith(".w")}
    assert convs and all(want[k][1] == "float32" for k in convs)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k] or (k in convs and got[k][0] == want[k][0]), (k, got[k], want[k])
    got = init_params(ours.cfg, torch.Generator().manual_seed(0), "meta")
    llm = ours.cfg.llm
    assert ("b" in got["llm"]["layers"]["attn"]["q"]) == llm.attention_bias == (family == "qwen")
    assert ("lm_head" in got["llm"]) == (not llm.tie_word_embeddings)


@pytest.mark.parametrize("family", ["llama", "qwen"])
def test_tokenizer_matches_jax(family):
    """Qwen: no BOS, pad = EOS, prompt ids without a leading BOS; Llama:
    BOS, its own pad, the prompt between BOS and EOS."""
    from omni_avsr_tpu.data.tokenizer import synthetic_tokenizer as jax_tokenizer

    ours, ref = synthetic_tokenizer(family, 151643), jax_tokenizer(family, 151643)
    for f in ("family", "vocab_size", "bos_id", "eos_id", "pad_id", "audio_sos_id",
              "audio_eos_id", "video_sos_id", "video_eos_id"):
        assert getattr(ours, f) == getattr(ref, f), f
    assert (ours.bos_id is None) == (ours.pad_id == ours.eos_id) == (family == "qwen")
    for text in ("Transcribe speech to text.", "Transcribe video to text.",
                 "Transcribe speech and video to text.", "the cat sat"):
        assert ours.encode(text) == ref.encode(text)
        np.testing.assert_array_equal(ours.prompt_ids(text), ref.prompt_ids(text))
        assert ours.decode(ours.encode(text)) == ref.decode(ref.encode(text))
    first = ours.encode("Transcribe speech to text.")[0]
    assert (first == ours.bos_id) == (family == "llama")


@pytest.mark.parametrize("name", ["Qwen/Qwen2.5-7B", "meta-llama/Meta-Llama-3.1-8B",
                                  "meta-llama/Llama-3.2-1B"])
def test_rope_matches_jax(name):
    """Qwen's plain rope (theta 1e6, no rescale), Llama-3.1's factor 8 and
    Llama-3.2's factor 32, at head dims 128 and 64, over positions past the
    rescale's original 8192."""
    from omni_avsr_tpu.ops.rope import apply_rope as japply, rope_cos_sin as jcos_sin
    from omni_avsr_tpu_torch.ops.rope import apply_rope, rope_cos_sin

    cfg = pcfg.LLM_REGISTRY[name]()
    rng = np.random.RandomState(0)
    pos = rng.randint(0, 20000, (2, 7)).astype(np.int32)
    jc, js = jcos_sin(jcfg.LLM_REGISTRY[name](), jnp.asarray(pos))
    c, s = rope_cos_sin(cfg, torch.from_numpy(pos))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5, rtol=1e-5)
    q = rng.randn(2, 7, cfg.num_heads, cfg.head_dim).astype(np.float32)
    k = rng.randn(2, 7, cfg.num_kv_heads, cfg.head_dim).astype(np.float32)
    jq, jk = japply(jnp.asarray(q), jnp.asarray(k), jc, js)
    tq, tk = apply_rope(torch.from_numpy(q), torch.from_numpy(k), c, s)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("ctor", ["whisper_base_en", "whisper_small_en"])
def test_whisper_size_matches_jax(ctor):
    """Whisper-base and Whisper-small at full width and depth through the
    port's encoder, on a short window (60 mel frames, 30 tokens)."""
    from omni_avsr_tpu.models.whisper import init_whisper_encoder, whisper_encode as jencode
    from omni_avsr_tpu_torch.models.whisper import whisper_encode

    cfg = getattr(jcfg, ctor)()
    params = jax.device_get(jax.jit(lambda k: init_whisper_encoder(k, cfg))(jax.random.PRNGKey(1)))
    mel = np.random.RandomState(2).randn(2, 60, 80).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, m: jencode(p, cfg, m))(params, jnp.asarray(mel)))
    ours = whisper_encode(params_from_numpy(params, "cpu"), getattr(pcfg, ctor)(),
                          torch.from_numpy(mel))
    assert ours.shape == (2, 30, cfg.hidden_size)
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-4, rtol=1e-3)


def test_avhubert_base_refused_by_both():
    """AV-HuBERT-Base is post-LN (`layer_norm_first=False`): the JAX
    encoder asserts pre-LN while it traces its first layer, and so does
    the port's before it runs anything."""
    from omni_avsr_tpu.models.avhubert import avhubert_encode as jencode, init_avhubert
    from omni_avsr_tpu_torch.models.avhubert import avhubert_encode

    jc = jcfg.avhubert_base()
    assert not jc.layer_norm_first
    shapes = jax.eval_shape(lambda k: init_avhubert(k, jc), jax.random.PRNGKey(0))
    video = jax.ShapeDtypeStruct((1, 4, 88, 88, 1), jnp.float32)
    with pytest.raises(AssertionError, match="post-LN"):
        jax.eval_shape(lambda p, v: jencode(p, jc, v), shapes, video)
    with pytest.raises(AssertionError, match="post-LN"):
        avhubert_encode({}, pcfg.avhubert_base(), torch.zeros(1, 4, 88, 88, 1))
