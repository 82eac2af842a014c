"""A tiny Qwen-2.5-style Omni model through the port against the JAX
package (`tests/torch_parity.py::jax_tiny_qwen`: family "qwen" with no BOS
and pad = EOS, q/k/v bias, rope theta 1e6 without rescale, rms eps 1e-6,
an untied lm_head, 6 query heads over 2 kv heads), on the same numpy
parameters, in f32 on both sides (`jax_in_f32`), the ancestor route of beam
attention (`OMNI_BEAM_ATTN=kernel`: the Pallas kernel in interpret mode on
the JAX side, B1's plain version here):

  - the masked decode prefix, without the BOS slot;
  - beam-15 and greedy tokens with no quantisation, int8 and packed int4;
  - the int8 and int4 decode trees bit-identical, the fused q|k|v bias
    and the untied head's codes included;
  - the three-task training losses on the Qwen layout [prefix | text].
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omni_avsr_tpu_torch.bridge import params_from_numpy
from omni_avsr_tpu_torch.serve import Transcriber, pad_batch
from tests.torch_parity import clips, jax_in_f32, jax_tiny_params, jax_tiny_qwen, port_model


@pytest.fixture(scope="module")
def qwen():
    jm = jax_tiny_qwen()
    params = jax_tiny_params(jm)
    items = clips((40, 33, 48), seed=3)
    batch, trim = pad_batch(items, "audiovisual")
    return jm, port_model(jm), params, batch, trim


def test_tiny_qwen_geometry(qwen):
    jm, pm, params, _, _ = qwen
    llm = pm.cfg.llm
    assert llm.family == "qwen" and llm.attention_bias and not llm.tie_word_embeddings
    assert llm.rope_scaling_factor is None and llm.rope_theta == 1e6 and llm.rms_norm_eps == 1e-6
    assert llm.num_heads // llm.num_kv_heads == 3
    assert pm.tok.bos_id is None and pm.tok.pad_id == pm.tok.eos_id
    attn = params["llm"]["layers"]["attn"]
    assert all("b" in attn[n] for n in "qkv") and "b" not in attn["o"]
    assert "lm_head" in params["llm"]


@pytest.mark.parametrize("modality", ["audiovisual", "audio", "video"])
def test_qwen_prefix_matches_jax(monkeypatch, qwen, modality):
    from omni_avsr_tpu.ops.augment import audio_pipeline as japp, video_pipeline as jvpp
    from omni_avsr_tpu_torch.ops.augment import audio_pipeline, video_pipeline

    jax_in_f32(monkeypatch)
    jm, pm, params, _, _ = qwen
    items = clips((20, 33), seed=2)
    batch, trim = pad_batch(items, modality)

    def jfn(p, b):
        b = dict(b)
        if "video" in b:
            b["video"] = jvpp(None, b["video"], b["video_len"], train=False)
        if "audio" in b:
            b["audio"] = japp(None, b["audio"], b["audio_len"], train=False)
        return jm.infer_prefix_masked(p, b, modality, 4, 2, trim)

    jemb, jvalid = jax.jit(jfn)(jax.tree_util.tree_map(jnp.asarray, params),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if "video" in tb:
        tb["video"] = video_pipeline(tb["video"], tb["video_len"])
    if "audio" in tb:
        tb["audio"] = audio_pipeline(tb["audio"], tb["audio_len"])
    temb, tvalid = pm.infer_prefix_masked(params_from_numpy(params, "cpu"), tb, modality, 4, 2,
                                          trim)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), atol=2e-4, rtol=1e-3)
    # no BOS: the first slot is the first modality's delimiter (or the prompt)
    first = {"audiovisual": pm.tok.audio_sos_id, "audio": pm.tok.audio_sos_id,
             "video": pm.tok.video_sos_id}[modality]
    emb = params["llm"]["embed"]["w"][first]
    np.testing.assert_allclose(temb[0, 0].numpy(), emb, atol=1e-6)
    P = pm.prefix_slots(modality, 4, 2, trim, batch["video"].shape[1] if "video" in batch else 0)
    assert P == -(-temb.shape[1] // 16) * 16


@pytest.mark.parametrize("quantize", [None, "int8", "int4"])
@pytest.mark.parametrize("num_beams", [15, 1], ids=["beam15", "greedy"])
def test_qwen_tokens_match_jax(monkeypatch, qwen, quantize, num_beams):
    from omni_avsr_tpu.serve import Transcriber as JaxTranscriber

    jax_in_f32(monkeypatch)
    monkeypatch.setenv("OMNI_BEAM_ATTN", "kernel")
    jm, pm, params, batch, trim = qwen
    jt = JaxTranscriber(jm, jax.tree_util.tree_map(jnp.asarray, params), num_beams=num_beams,
                        quantize=quantize)
    jfn = jt.engine._decode_fn("audiovisual", 4, 2, trim, num_beams, 32)
    jax_ids = np.asarray(jfn(jt.params, {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.PRNGKey(0)))
    pt = Transcriber(pm, params_from_numpy(params, "cpu"), num_beams=num_beams,
                     quantize=quantize, device="cpu")
    if quantize:
        qkv = pt.params["llm"]["layers"]["attn"]["qkv"]
        assert set(qkv) == {"wc" if quantize == "int8" else "w4c", "s", "b"}
    ids = pt.decode_ids(batch, "audiovisual", 4, 2, trim, num_beams).numpy()
    np.testing.assert_array_equal(ids, jax_ids)
    assert 1 <= pt.last_decode_steps <= 32


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_qwen_decode_tree_matches_jax(qwen, mode):
    """`quantize_for_decode`: codes (int8, or the packed int4 bytes) and
    scales bit-identical to the JAX tree's, the q|k|v bias fused unquantised
    and equal, the untied lm_head quantised; the card layout keeps the
    bias and gives the same codes back."""
    from omni_avsr_tpu.ops.quant import quantize_for_decode as jquant
    from omni_avsr_tpu_torch.ops.quant import arrange_for_card, int4_codes, int8_codes
    from omni_avsr_tpu_torch.ops.quant import quantize_for_decode

    _, _, params, _, _ = qwen
    ref = _flat(jax.device_get(jquant(jax.tree_util.tree_map(jnp.asarray, params), mode)))
    ours = quantize_for_decode(params_from_numpy(params, "cpu"), mode)
    flat = _flat(ours)
    assert flat.keys() == ref.keys()
    for k, v in flat.items():
        r = np.asarray(ref[k])
        got = v.numpy() if v.dtype != torch.bfloat16 else v.float().numpy()
        if r.dtype == np.uint8:
            got = got.view(np.uint8)
        assert got.dtype == r.dtype and got.shape == r.shape, k
        np.testing.assert_array_equal(got, r, err_msg=k)
    llm = ours["llm"]
    key = "w" if mode == "int8" else "w4"
    assert "b" in llm["layers"]["attn"]["qkv"] and llm["lm_head"][key].dtype == torch.int8
    np.testing.assert_array_equal(
        llm["layers"]["attn"]["qkv"]["b"].numpy(),
        np.concatenate([params["llm"]["layers"]["attn"][n]["b"] for n in "qkv"], axis=-1))
    card = arrange_for_card(llm)
    qkv = card["layers"]["attn"]["qkv"]
    assert qkv["b"] is llm["layers"]["attn"]["qkv"]["b"]
    k_in = params["llm"]["layers"]["attn"]["q"]["w"].shape[1]
    codes = (int8_codes if mode == "int8" else int4_codes)(
        {kk: v[0] for kk, v in qkv.items()}, k_in)
    want = llm["layers"]["attn"]["qkv"]["w"][0] if mode == "int8" else int4_codes(
        {kk: v[0] for kk, v in llm["layers"]["attn"]["qkv"].items()}, k_in)
    np.testing.assert_array_equal(codes.numpy(), want.numpy())


def test_qwen_train_losses_match_jax(monkeypatch, qwen):
    """The three task losses on the Qwen layout [prefix | text EOS] (no BOS;
    the logits span starts one slot before the text), eval preprocessing,
    eval-mode towers, no remat."""
    from omni_avsr_tpu.ops.augment import audio_pipeline as japp, video_pipeline as jvpp
    from omni_avsr_tpu_torch.ops.augment import audio_pipeline, video_pipeline

    jax_in_f32(monkeypatch)
    jm, pm, params, batch, trim = qwen
    rng = np.random.RandomState(9)
    tokens = [pm.tok.encode(" ".join(f"w{i}" for i in rng.randint(0, 40, n))) for n in (5, 7, 3)]
    width = max(len(t) for t in tokens)
    tok = np.full((3, width), pm.tok.pad_id, np.int32)
    lab = np.full((3, width), -100, np.int32)
    for b, t in enumerate(tokens):
        tok[b, :len(t)] = t
        lab[b, :len(t)] = t
    full = {**batch, "tokens": tok, "labels": lab}

    def jfn(p, b):
        b = dict(b)
        b["video"] = jvpp(None, b["video"], b["video_len"], train=False)
        b["audio"] = japp(None, b["audio"], b["audio_len"], train=False)
        return jm.train_losses(p, b, 4, 2, trim, train_mode=False, remat=False)

    ref = jax.jit(jfn)(jax.tree_util.tree_map(jnp.asarray, params),
                       {k: jnp.asarray(v) for k, v in full.items()})
    tb = {k: torch.from_numpy(v) for k, v in full.items()}
    tb["video"] = video_pipeline(tb["video"], tb["video_len"])
    tb["audio"] = audio_pipeline(tb["audio"], tb["audio_len"])
    with torch.no_grad():
        ours = pm.train_losses(params_from_numpy(params, "cpu"), tb, 4, 2, trim,
                               train_mode=False, remat="off")
    for m in ours:
        np.testing.assert_allclose(float(ours[m]), float(ref[m]), rtol=1e-4, atol=1e-5)
