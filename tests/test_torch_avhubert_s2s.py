"""Parity of the port's AV-HuBERT seq2seq and CTC heads with the JAX
package (`omni_avsr_tpu/models/avhubert_s2s.py`,
`omni_avsr_tpu/convert/avhubert_s2s_torch.py`), at tiny widths in f32.

Inputs and the decoder tree are made once per file from numpy seeds and
the JAX package's initialiser, and carried across with
`params_from_numpy`. Tolerances: logits and losses atol 1e-4 / rtol 1e-4
(f32, a few layers: the sums are ordered differently in XLA and torch);
decodes token-identical; the converter and the sinusoids exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni_avsr_tpu.models import avhubert_s2s as jm
from omni_avsr_tpu_torch.bridge import init_ctc_head, init_s2s_decoder, params_from_numpy
from omni_avsr_tpu_torch.models import avhubert_s2s as pm

TOL = dict(atol=1e-4, rtol=1e-4)
B, S, DE, V = 2, 11, 48, 40
LENS = np.array([11, 7], np.int32)


def _cfg(mod, **kw):
    return mod.S2SDecoderConfig(vocab_size=V, embed_dim=32, ffn_dim=64, layers=2, heads=4,
                                encoder_dim=DE, max_target_positions=64, **kw)


@pytest.fixture(scope="module")
def tree():
    """(JAX tree, port tree, encoder output) for a tied and an untied head."""
    out = {}
    rng = np.random.RandomState(0)
    enc = (rng.randn(B, S, DE) * 0.5).astype(np.float32)
    for tied in (True, False):
        jp = jax.device_get(jm.init_s2s_decoder(jax.random.PRNGKey(1), _cfg(
            jm, share_input_output_embed=tied)))
        out[tied] = (jp, params_from_numpy(jp, "cpu"), enc)
    return out


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("tied", [True, False])
def test_decoder_forward_and_ce_match_jax(tree, tied):
    jp, tp, enc = tree[tied]
    rng = np.random.RandomState(2)
    prev = rng.randint(3, V, (B, 7)).astype(np.int32)
    prev[1, 5:] = 1  # pad positions take position pad_id
    tgt = rng.randint(3, V, (B, 7)).astype(np.int32)
    tgt[1, 5:] = 1
    jl = jm.s2s_decoder_forward(jp, _cfg(jm, share_input_output_embed=tied), jnp.asarray(prev),
                                jnp.asarray(enc), jnp.asarray(LENS))
    pl = pm.s2s_decoder_forward(tp, _cfg(pm, share_input_output_embed=tied), _t(prev), _t(enc),
                                _t(LENS))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    assert pl.dtype == torch.float32
    jce = jm.s2s_cross_entropy(jl, jnp.asarray(tgt), 1)
    pce = pm.s2s_cross_entropy(pl, _t(tgt), 1)
    np.testing.assert_allclose(float(pce), float(jce), **TOL)


def test_ctc_loss_matches_optax():
    """Feasible lengths only: where no alignment exists optax returns its
    large finite log-epsilon value and torch inf."""
    jh = jax.device_get(jm.init_ctc_head(jax.random.PRNGKey(3), DE, 30))
    rng = np.random.RandomState(4)
    enc = rng.randn(3, 20, DE).astype(np.float32)
    targets = rng.randint(1, 30, (3, 6)).astype(np.int32)
    enc_lens, tgt_lens = np.array([20, 15, 9], np.int32), np.array([6, 3, 4], np.int32)
    want = jm.ctc_loss(jh, jnp.asarray(enc), jnp.asarray(enc_lens), jnp.asarray(targets),
                       jnp.asarray(tgt_lens), blank_id=0)
    got = pm.ctc_loss(params_from_numpy(jh, "cpu"), _t(enc), _t(enc_lens), _t(targets),
                      _t(tgt_lens), blank_id=0)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_cross_precompute_and_shared_cross_step(tree):
    jp, tp, enc = tree[True]
    jk, jv = jm.s2s_precompute_cross(jp, _cfg(jm), jnp.asarray(enc))
    pk, pv = pm.s2s_precompute_cross(tp, _cfg(pm), _t(enc))
    assert tuple(pk.shape) == (2, B, S, 4, 8)
    np.testing.assert_allclose(pk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), **TOL)
    # K beams over one copy of the cross K/V per sample == K replicated copies
    K, N, cfg = 3, 5, _cfg(pm)
    mask = pm.padding_mask_from_lengths(_t(LENS), S)[:, None, None, :]
    tok = torch.from_numpy(np.random.RandomState(5).randint(3, V, (B * K,)))
    sk = torch.randn(2, B * K, N, 4, 8, generator=torch.Generator().manual_seed(0))
    sv = torch.randn(2, B * K, N, 4, 8, generator=torch.Generator().manual_seed(1))
    shared, _, _ = pm._s2s_decode_step(tp, cfg, tok, 2, sk.clone(), sv.clone(), pk, pv, mask,
                                       beams=K)
    rep = lambda x: x.repeat_interleave(K, dim=1)  # noqa: E731
    replicated, _, _ = pm._s2s_decode_step(tp, cfg, tok, 2, sk.clone(), sv.clone(), rep(pk),
                                           rep(pv), mask.repeat_interleave(K, dim=0))
    np.testing.assert_allclose(shared.numpy(), replicated.numpy(), atol=1e-5, rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_decode(num_beams: int, max_new: int):
    cfg = _cfg(jm)
    if num_beams == 0:
        return jax.jit(lambda p, e, n: jm.s2s_greedy_decode(p, cfg, e, n, max_new))
    return jax.jit(lambda p, e, n: jm.s2s_beam_decode(p, cfg, e, n, max_new, num_beams))


@pytest.mark.parametrize("num_beams", [0, 1, 4], ids=["greedy", "beam1", "beam4"])
def test_decodes_token_identical(tree, num_beams):
    jp, tp, enc = tree[True]
    # a larger encoder scale spreads the logits, so near-ties do not decide
    enc = enc * 4.0
    want = np.asarray(_jax_decode(num_beams, 8)(jp, jnp.asarray(enc), jnp.asarray(LENS)))
    if num_beams == 0:
        got = pm.s2s_greedy_decode(tp, _cfg(pm), _t(enc), _t(LENS), 8)
    else:
        got = pm.s2s_beam_decode(tp, _cfg(pm), _t(enc), _t(LENS), 8, num_beams)
    assert got.tokens.numpy().tolist() == want.tolist()


def test_greedy_stops_once_every_row_ends(tree):
    """The host loop's early exit: with EOS made the argmax everywhere,
    one step, EOS first, pad after."""
    jp, tp, enc = tree[False]
    cfg = _cfg(pm, share_input_output_embed=False)
    # the last layer's output norm shifted by +1, the head's EOS column
    # all 10s: EOS's logit is ~10 x 32 above the others
    norm = {k: v.clone() for k, v in tp["layers"]["final_norm"].items()}
    norm["bias"][-1] = 1.0
    head = tp["embed_out"]["w"].clone()
    head[:, cfg.eos_id] = 10.0
    tp = {**tp, "layers": {**tp["layers"], "final_norm": norm}, "embed_out": {"w": head}}
    out = pm.s2s_greedy_decode(tp, cfg, _t(enc), _t(LENS), 6)
    assert out.steps == 1
    assert out.tokens.tolist() == [[cfg.eos_id] + [cfg.pad_id] * 5] * B


def test_converter_matches_jax_tree():
    from omni_avsr_tpu.config import AVHubertConfig as JCfg
    from omni_avsr_tpu.convert.avhubert_s2s_torch import convert_avhubert_s2s as jconvert
    from omni_avsr_tpu_torch.config import AVHubertConfig as PCfg
    from omni_avsr_tpu_torch.convert.avhubert_s2s_torch import convert_avhubert_s2s
    from test_eval_avhubert_s2s_cli import _s2s_state_dict

    sd = _s2s_state_dict(vocab=24)
    sd["decoder.embed_out"] = torch.randn(24, 32) * 0.05  # an untied head
    enc_kw = dict(encoder_layers=2, encoder_embed_dim=64, encoder_heads=4, encoder_ffn_dim=128)
    dec_kw = dict(vocab_size=24, embed_dim=32, ffn_dim=64, layers=2, heads=4, encoder_dim=64)
    je, jd = jax.device_get(jconvert(sd, JCfg(**enc_kw), jm.S2SDecoderConfig(**dec_kw),
                                     dtype=jnp.float32))
    pe, pd = convert_avhubert_s2s(sd, PCfg(**enc_kw), pm.S2SDecoderConfig(**dec_kw),
                                  dtype=torch.float32)

    def check(j, p, path=""):
        assert sorted(j) == sorted(p), path
        for k in j:
            if isinstance(j[k], dict):
                check(j[k], p[k], f"{path}.{k}")
            else:
                np.testing.assert_array_equal(p[k].numpy(), np.asarray(j[k]), err_msg=path + k)

    check(je, pe)
    check(jd, pd)
    assert "embed_out" in pd


def test_builders_give_the_jax_shapes():
    """`bridge.init_s2s_decoder` / `init_ctc_head` build the JAX trees'
    shapes (random values from a generator), and the sinusoids exactly."""
    g = torch.Generator().manual_seed(0)
    for tied in (True, False):
        jp = jax.eval_shape(lambda k: jm.init_s2s_decoder(k, _cfg(
            jm, share_input_output_embed=tied)), jax.random.PRNGKey(0))
        tp = init_s2s_decoder(_cfg(pm, share_input_output_embed=tied), g, "cpu")
        assert (jax.tree_util.tree_map(lambda x: tuple(x.shape), jp)
                == jax.tree_util.tree_map(lambda x: tuple(x.shape), tp))
        np.testing.assert_array_equal(tp["pos"].numpy(), jm.sinusoidal_embedding(66, 32, 1))
    head = init_ctc_head(DE, 30, g, "cpu")
    assert tuple(head["proj"]["w"].shape) == (DE, 30) and tuple(head["proj"]["b"].shape) == (30,)


def test_state_dict_round_trip():
    """`avhubert_s2s_state_dict` (the smoke run's synthetic checkpoints) is
    what `convert_avhubert_s2s` reads back: the same tree, the positional
    conv within its weight-norm refold's f32 rounding."""
    from omni_avsr_tpu_torch.bridge import init_avhubert
    from omni_avsr_tpu_torch.config import AVHubertConfig as PCfg
    from omni_avsr_tpu_torch.convert.avhubert_s2s_torch import (
        avhubert_s2s_state_dict,
        convert_avhubert_s2s,
    )

    g = torch.Generator().manual_seed(0)
    ecfg = PCfg(encoder_embed_dim=64, encoder_layers=2, encoder_heads=4, encoder_ffn_dim=128)
    dcfg = _cfg(pm, share_input_output_embed=False)
    dcfg = pm.S2SDecoderConfig(**{**dcfg.__dict__, "encoder_dim": 64})
    enc, dec = init_avhubert(ecfg, g, "cpu"), init_s2s_decoder(dcfg, g, "cpu")
    sd = {k: torch.from_numpy(v) for k, v in avhubert_s2s_state_dict(enc, dec).items()}
    enc2, dec2 = convert_avhubert_s2s(sd, ecfg, dcfg, dtype=torch.float32)
    flat = lambda t: jax.tree_util.tree_leaves_with_path(t)  # noqa: E731
    for (pa, a), (pb, b) in zip(flat({"e": enc, "d": dec}), flat({"e": enc2, "d": dec2})):
        assert pa == pb
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-7, rtol=1e-6, err_msg=str(pa))
