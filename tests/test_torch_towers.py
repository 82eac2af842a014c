"""The port's leaf ops and encoder towers against the JAX package, in f32 at
tiny widths: the same numpy inputs and the same parameter tree (the JAX
initialiser's, bridged) go through both. Towers at the JAX package's own
tower tolerance, atol 2e-4 / rtol 1e-3 (tests/test_audio_tower.py:82), with
f32 and with int8 (quantize_for_decode) weights. The random tower trees
come from the port's `bridge.init_params` at the tiny flagship widths (the
JAX initialiser's own tree is carried across in test_torch_slice.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omni_avsr_tpu.config import AVHubertConfig, LLMConfig, WhisperEncoderConfig
from omni_avsr_tpu_torch import config as tcfg
from omni_avsr_tpu_torch.bridge import init_params, params_from_numpy
from omni_avsr_tpu_torch.models.omni import flagship
from tests.torch_parity import randomize_lora_down

TOWER_TOL = dict(atol=2e-4, rtol=1e-3)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def tiny_tree():
    """numpy f32 tree of the tiny flagship (LoRA downs randomised) and its config."""
    model = flagship(tiny=True, dtype=torch.float32)
    params = init_params(model.cfg, torch.Generator().manual_seed(0), "cpu",
                         frozen_dtype=torch.float32)

    def to_numpy(node):
        return {k: (to_numpy(v) if isinstance(v, dict) else v.numpy()) for k, v in node.items()}

    return randomize_lora_down(to_numpy(params)), model.cfg


def _maybe_quantize(jparams, int8):
    """Quantize the numpy tree with the JAX package (the port's own
    quantizer is pinned bit-identical in test_torch_quant.py)."""
    if not int8:
        return jparams
    from omni_avsr_tpu.ops.quant import quantize_tower_params

    return jax.device_get(quantize_tower_params(jax.tree_util.tree_map(jnp.asarray, jparams)))


@pytest.mark.parametrize("int8", [False, True])
def test_whisper_encode(tiny_tree, int8):
    from omni_avsr_tpu.models.whisper import whisper_encode as jax_whisper
    from omni_avsr_tpu_torch.models.whisper import whisper_encode

    kw = dict(hidden_size=64, num_layers=2, num_heads=4, ffn_dim=128)
    assert tiny_tree[1].whisper == tcfg.WhisperEncoderConfig(**kw)
    jp = _maybe_quantize(tiny_tree[0]["whisper"], int8)
    mel = np.random.RandomState(1).randn(2, 650, 80).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x: jax_whisper(p, WhisperEncoderConfig(**kw), x))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(mel)))
    ours = whisper_encode(params_from_numpy(jp, "cpu"), tcfg.WhisperEncoderConfig(**kw), _t(mel))
    assert ours.shape == (2, 325, 64)
    np.testing.assert_allclose(ours.numpy(), ref, **TOWER_TOL)


def test_resnet3d_forward(tiny_tree):
    from omni_avsr_tpu.models.resnet3d import resnet3d_forward as jax_resnet
    from omni_avsr_tpu_torch.models.resnet3d import resnet3d_forward

    jp = jax.tree_util.tree_map(np.copy, tiny_tree[0]["avhubert"]["video_frontend"])
    rng = np.random.RandomState(2)
    # non-trivial BN statistics so the folds are exercised
    for node in (jp["stem"]["bn"], jp["layer2"]["b0"]["bn1"], jp["layer3"]["b0"]["downsample"]["bn"]):
        c = node["scale"].shape[0]
        node["mean"] = (rng.randn(c) * 0.1).astype(np.float32)
        node["var"] = (rng.rand(c) + 0.5).astype(np.float32)
        node["scale"] = (rng.rand(c) + 0.5).astype(np.float32)
    video = rng.randn(2, 5, 88, 88, 1).astype(np.float32)
    ref = np.asarray(jax.jit(jax_resnet)(jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(video)))
    ours = resnet3d_forward(params_from_numpy(jp, "cpu"), _t(video))
    assert ours.shape == (2, 5, 512)
    np.testing.assert_allclose(ours.numpy(), ref, **TOWER_TOL)


@pytest.mark.parametrize("int8", [False, True])
def test_avhubert_encode(tiny_tree, int8):
    from omni_avsr_tpu.models.avhubert import avhubert_encode as jax_avhubert
    from omni_avsr_tpu_torch.models.avhubert import avhubert_encode

    kw = dict(encoder_embed_dim=64, encoder_layers=2, encoder_heads=4, encoder_ffn_dim=128,
              audio_feat_dim=26, lora_rank_divisor=16)
    assert tiny_tree[1].avhubert == tcfg.AVHubertConfig(**kw)
    jp = _maybe_quantize(tiny_tree[0]["avhubert"], int8)
    video = np.random.RandomState(3).randn(2, 6, 88, 88, 1).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x: jax_avhubert(p, AVHubertConfig(**kw), x))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(video)))
    ours = avhubert_encode(params_from_numpy(jp, "cpu"), tcfg.AVHubertConfig(**kw), _t(video))
    assert ours.shape == (2, 6, 64)
    np.testing.assert_allclose(ours.numpy(), ref, **TOWER_TOL)


def test_avhubert_encode_lengths(tiny_tree):
    """Eval with per-clip lengths: padded frames masked as keys, the masked
    plain route (the card takes B3 with `kv_lengths` at T >= 256)."""
    from omni_avsr_tpu.models.avhubert import avhubert_encode as jax_avhubert
    from omni_avsr_tpu_torch.models.avhubert import avhubert_encode

    cfg = tiny_tree[1].avhubert
    jp = tiny_tree[0]["avhubert"]
    video = np.random.RandomState(8).randn(2, 7, 88, 88, 1).astype(np.float32)
    lengths = np.array([7, 4], np.int32)
    jcfg = AVHubertConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    ref = np.asarray(jax.jit(lambda p, x, n: jax_avhubert(p, jcfg, x, lengths=n))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(video), jnp.asarray(lengths)))
    ours = avhubert_encode(params_from_numpy(jp, "cpu"), cfg, _t(video), lengths=_t(lengths))
    np.testing.assert_allclose(ours.numpy(), ref, **TOWER_TOL)
    unmasked = avhubert_encode(params_from_numpy(jp, "cpu"), cfg, _t(video))
    assert not np.allclose(unmasked.numpy()[1], ours.numpy()[1], atol=1e-3)


@pytest.mark.parametrize("op", ["layer_norm", "rms_norm", "batch_norm_inference"])
def test_norms(op):
    import omni_avsr_tpu.ops.norms as jn
    import omni_avsr_tpu_torch.ops.norms as tn

    rng = np.random.RandomState(4)
    x = rng.randn(3, 7, 32).astype(np.float32) * 3 + 1
    args = [rng.randn(32).astype(np.float32) for _ in range(4)]
    if op == "layer_norm":
        args = args[:2]
    elif op == "rms_norm":
        args = args[:1]
    else:
        args[3] = np.abs(args[3]) + 0.1  # variance
    ref = np.asarray(getattr(jn, op)(jnp.asarray(x), *map(jnp.asarray, args)))
    ours = getattr(tn, op)(_t(x), *map(_t, args)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)


def test_rope_llama3_scaling():
    from omni_avsr_tpu.ops.rope import apply_rope as japply, rope_cos_sin as jcs
    from omni_avsr_tpu_torch.ops.rope import apply_rope, rope_cos_sin

    kw = dict(head_dim=64, num_heads=4, num_kv_heads=2)
    rng = np.random.RandomState(5)
    pos = rng.randint(0, 3000, (2, 9)).astype(np.int32)
    q = rng.randn(2, 9, 4, 64).astype(np.float32)
    k = rng.randn(2, 9, 2, 64).astype(np.float32)
    jc, js = jcs(LLMConfig(**kw), jnp.asarray(pos))
    c, s = rope_cos_sin(tcfg.LLMConfig(**kw), _t(pos))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)
    jq, jk = japply(jnp.asarray(q), jnp.asarray(k), jc, js)
    tq, tk = apply_rope(_t(q), _t(k), c, s)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)


@pytest.mark.parametrize("mask", ["none", "causal_padding", "additive"])
def test_dot_product_attention(mask):
    import omni_avsr_tpu.ops.attention as ja
    import omni_avsr_tpu_torch.ops.attention as ta

    rng = np.random.RandomState(6)
    q = rng.randn(2, 5, 8, 16).astype(np.float32)
    k = rng.randn(2, 7, 2, 16).astype(np.float32)
    v = rng.randn(2, 7, 2, 16).astype(np.float32)
    jm = tm = None
    if mask == "causal_padding":
        lengths = np.array([7, 4], np.int32)
        jm = ja.causal_mask(5, 7) & ja.padding_mask_from_lengths(
            jnp.asarray(lengths), 7)[:, None, None, :]
        tm = ta.causal_mask(5, 7) & ta.padding_mask_from_lengths(
            _t(lengths), 7)[:, None, None, :]
    elif mask == "additive":
        add = (rng.randn(2, 1, 5, 7) * 2).astype(np.float32)
        jm, tm = jnp.asarray(add), _t(add)
    ref = np.asarray(ja.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jm))
    ours = ta.dot_product_attention(_t(q), _t(k), _t(v), mask=tm).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode,rate", [("avg-pooling", 4), ("avg-pooling", 2), ("stack", 3)])
def test_compress(mode, rate):
    from omni_avsr_tpu.ops.pooling import compress as jcompress
    from omni_avsr_tpu_torch.ops.pooling import compress

    x = np.random.RandomState(7).randn(2, 13, 8).astype(np.float32)
    np.testing.assert_allclose(compress(_t(x), rate, mode).numpy(),
                               np.asarray(jcompress(jnp.asarray(x), rate, mode)), atol=1e-6)
