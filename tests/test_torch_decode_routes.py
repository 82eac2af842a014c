"""The decode routes of the reference numerics profile against the JAX
package, at the tiny flagship widths, f32 on both sides:

  - the reorder route (`attn_route="xla"`: `SplitCache` and the three-block
    joint softmax, the JAX package's CPU default) in beam search and greedy
    decoding, over a gap-tolerant (`key_valid`) and a contiguous
    (`prefix_len`) prefix: token-identical;
  - grid selection (`select_mode="grid"`, JAX's `_SELECT_MODE` patched to
    "grid" for the test) and the n-gram ban (`no_repeat_ngram_size=2`):
    token-identical;
  - `llm_prefill`, `llm_decode_step` and one `llm_decode_step_beam` after a
    reorder: logits within 2e-5;
  - `infer_prefix`, the contiguous decode prefix: within the towers'
    atol 2e-4 / rtol 1e-3.
One jitted JAX function per case; the model, tree and prefix are shared.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omni_avsr_tpu_torch.bridge import params_from_numpy
from omni_avsr_tpu_torch.models.omni import flagship
from tests.torch_parity import jax_in_f32, jax_tiny_flagship, jax_tiny_params

B, P, K, MAX_NEW = 2, 16, 4, 12


@pytest.fixture(scope="module")
def setup():
    jm = jax_tiny_flagship()
    params = jax_tiny_params(jm)
    pm = flagship(tiny=True, dtype=torch.float32, whisper_input_mode="bucket")
    rng = np.random.RandomState(11)
    emb = (rng.randn(B, P, jm.cfg.llm.hidden_size) * 0.5).astype(np.float32)
    valid = rng.rand(B, P) < 0.75
    valid[:, 0] = True
    prefix_len = np.array([P, P - 5], np.int32)
    return dict(jm=jm, pm=pm, jllm=jax.tree_util.tree_map(jnp.asarray, params["llm"]),
                tllm=params_from_numpy(params["llm"], "cpu"), params=params, emb=emb,
                valid=valid, prefix_len=prefix_len)


def _decode(s, fn_name, prefix, **kw):
    """(JAX ids, the port's ids) of `beam_search` or `greedy_decode` on the
    shared prefix, gap-tolerant or contiguous."""
    import omni_avsr_tpu.decode.decoding as jdec

    import omni_avsr_tpu_torch.decode.decoding as tdec

    tok = s["jm"].tok
    common = dict(max_new=MAX_NEW, eos_id=tok.eos_id, pad_id=tok.pad_id, modality="audio")
    if fn_name == "beam_search":
        common["num_beams"] = K
    if prefix == "key_valid":
        jpre, tpre = {"key_valid": jnp.asarray(s["valid"])}, {
            "key_valid": torch.from_numpy(s["valid"])}
    else:
        jpre, tpre = {"prefix_len": jnp.asarray(s["prefix_len"])}, {
            "prefix_len": torch.from_numpy(s["prefix_len"]).long()}
    jax_kw = {k: v for k, v in kw.items() if k != "select_mode"}
    jfn = jax.jit(functools.partial(getattr(jdec, fn_name), cfg=s["jm"].cfg.llm,
                                    cache_dtype=jnp.float32, attn_route="xla",
                                    **common, **jax_kw))
    want = np.asarray(jfn(s["jllm"], prefix_embeds=jnp.asarray(s["emb"]), **jpre))
    out = getattr(tdec, fn_name)(s["tllm"], s["pm"].cfg.llm, torch.from_numpy(s["emb"]),
                                 cache_dtype=torch.float32, attn_route="xla", **common,
                                 **tpre, **kw)
    return want, out.tokens.numpy()


@pytest.mark.parametrize("fn_name", ["beam_search", "greedy_decode"])
@pytest.mark.parametrize("prefix", ["key_valid", "prefix_len"])
def test_reorder_route_matches_jax(setup, monkeypatch, fn_name, prefix):
    jax_in_f32(monkeypatch)
    want, got = _decode(setup, fn_name, prefix)
    np.testing.assert_array_equal(got, want)


def test_grid_selection_matches_jax(setup, monkeypatch):
    import omni_avsr_tpu.decode.decoding as jdec

    jax_in_f32(monkeypatch)
    monkeypatch.setattr(jdec, "_SELECT_MODE", "grid")
    want, got = _decode(setup, "beam_search", "key_valid", select_mode="grid")
    np.testing.assert_array_equal(got, want)


def _bigrams(row, pad_id):
    toks = [t for t in row if t != pad_id]
    return [tuple(toks[i:i + 2]) for i in range(len(toks) - 1)]


def test_ngram_ban_matches_jax(setup, monkeypatch):
    jax_in_f32(monkeypatch)
    pad = setup["jm"].tok.pad_id
    want, got = _decode(setup, "beam_search", "key_valid", no_repeat_ngram_size=2)
    np.testing.assert_array_equal(got, want)
    for row in got:
        grams = _bigrams(row, pad)
        assert len(grams) == len(set(grams)), row
    # the ban changed what was decoded: the unbanned beams repeat a bigram
    _, free = _decode(setup, "beam_search", "key_valid")
    assert any(len(g) != len(set(g)) for g in (_bigrams(r, pad) for r in free))


def test_prefill_and_decode_steps_match_jax(setup, monkeypatch):
    """Contiguous prefill, two `llm_decode_step`s on the contiguous cache,
    and one reorder-route beam step after a reorder of the split cache."""
    import omni_avsr_tpu.models.llm as jl

    import omni_avsr_tpu_torch.models.llm as tl

    jax_in_f32(monkeypatch)
    s = setup
    jcfg, tcfg = s["jm"].cfg.llm, s["pm"].cfg.llm
    H = jcfg.hidden_size
    rng = np.random.RandomState(3)
    toks = (rng.randn(2, B, 1, H) * 0.5).astype(np.float32)
    beam_tok = (rng.randn(B * K, 1, H) * 0.5).astype(np.float32)
    flat_idx = (rng.randint(0, K, (B, K)) + np.arange(B)[:, None] * K).reshape(-1)
    S = P + 4

    @jax.jit
    def jax_side(llm, emb, plen, toks, beam_tok, flat_idx):
        cache = jl.KVCache.create(jcfg, B, S, dtype=jnp.float32)
        l0, cache = jl.llm_prefill(llm, jcfg, emb, plen, cache, "audio")
        steps = []
        for t in range(2):
            lt, cache = jl.llm_decode_step(llm, jcfg, toks[t], t, plen, P, cache, "audio")
            steps.append(lt)
        split = jl.SplitCache.from_prefill(cache, P, K, 4)
        split = jl.SplitCache(split.prefix_k, split.prefix_v, split.gen_k + 0.01,
                              split.gen_v - 0.01)  # a cache with something to reorder
        n_valid = jnp.repeat(plen, K)
        mask = jnp.arange(P)[None] < plen[:, None]
        lb, _ = jl.llm_decode_step_beam(llm, jcfg, beam_tok, 2, n_valid, mask,
                                        split.reorder(flat_idx), K, "audio")
        return l0, steps, lb

    plen = s["prefix_len"]
    w0, wsteps, wb = jax_side(s["jllm"], jnp.asarray(s["emb"]), jnp.asarray(plen),
                              jnp.asarray(toks), jnp.asarray(beam_tok), jnp.asarray(flat_idx))
    tplen = torch.from_numpy(plen).long()
    cache = tl.KVCache.create(tcfg, B, S, dtype=torch.float32)
    l0, cache = tl.llm_prefill(s["tllm"], tcfg, torch.from_numpy(s["emb"]), tplen, cache,
                               "audio")
    np.testing.assert_allclose(l0.numpy(), np.asarray(w0), atol=2e-5, rtol=2e-5)
    for t in range(2):
        lt, cache = tl.llm_decode_step(s["tllm"], tcfg, torch.from_numpy(toks[t]), t, tplen, P,
                                       cache, "audio")
        np.testing.assert_allclose(lt.numpy(), np.asarray(wsteps[t]), atol=2e-5, rtol=2e-5)
    split = tl.SplitCache.from_prefill(cache, P, K, 4)
    split.gen_k += 0.01
    split.gen_v -= 0.01
    mask = torch.arange(P)[None] < tplen[:, None]
    lb, _ = tl.llm_decode_step_beam(s["tllm"], tcfg, torch.from_numpy(beam_tok), 2,
                                    tplen.repeat_interleave(K), mask,
                                    split.reorder_(torch.from_numpy(flat_idx).long()), K, "audio")
    np.testing.assert_allclose(lb.numpy(), np.asarray(wb), atol=2e-5, rtol=2e-5)


def test_infer_prefix_matches_jax(setup, monkeypatch):
    from omni_avsr_tpu.ops.augment import audio_pipeline, video_pipeline

    from tests.torch_parity import clips
    from omni_avsr_tpu_torch.serve import pad_batch

    jax_in_f32(monkeypatch)
    s = setup
    batch, trim = pad_batch(clips((20, 16), seed=2), "audiovisual")
    proc = dict(batch)
    proc["video"] = np.asarray(video_pipeline(None, batch["video"], batch["video_len"], False))
    proc["audio"] = np.asarray(audio_pipeline(None, batch["audio"], batch["audio_len"], False))
    params = jax.tree_util.tree_map(jnp.asarray, s["params"])
    want = np.asarray(jax.jit(lambda p, b: s["jm"].infer_prefix(
        p, b, "audiovisual", 4, 2, trim))(params, {k: jnp.asarray(v) for k, v in proc.items()}))
    pm = flagship(tiny=True, dtype=torch.float32, whisper_input_mode="bucket")
    got = pm.infer_prefix(params_from_numpy(s["params"], "cpu"),
                          {k: torch.from_numpy(np.array(v)) for k, v in proc.items()},
                          "audiovisual", 4, 2, trim)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)
