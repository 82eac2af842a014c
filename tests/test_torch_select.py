"""The selection-stats kernel's slice of the port (B5) against the JAX
package: `row_stats_chunkmax`'s plain version against the Pallas kernel in
interpret mode, `topk_chunked` with precomputed chunk maxima, and the beam
loop's kernel route (`select_kernel=True`), on the same numpy inputs.

Chunk maxima and row maxima are exact on both sides (a max is); the
normaliser is summed in another order, so it is held at rtol 1e-6, the
JAX package's own bound for its kernel (tests/test_select_kernel.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omni_avsr_tpu.decode.decoding import beam_loop as jax_beam_loop
from omni_avsr_tpu.decode.decoding import topk_chunked as jax_topk_chunked
from omni_avsr_tpu.ops.select_topk import row_stats_chunkmax as jax_row_stats
from omni_avsr_tpu.ops.select_topk import select_stats_supported as jax_supported
from omni_avsr_tpu_torch.decode.decoding import beam_loop, beam_search, topk_chunked
from omni_avsr_tpu_torch.ops.select_topk import (
    BLOCKS_PER_SM,
    MIN_CHUNKS,
    row_plan,
    row_stats_chunkmax,
    row_stats_chunkmax_plain,
    row_stats_chunkmax_split,
    select_stats_supported,
)


@pytest.mark.parametrize("R,V", [(15, 16384), (13, 1280), (45, 128 * 7), (8, 128 * 130)])
def test_row_stats_plain_matches_jax_kernel(R, V):
    rng = np.random.RandomState(R + V)
    x = (rng.randn(R, V) * 4).astype(np.float32)
    jcm, jmx, jse = jax_row_stats(jnp.asarray(x), interpret=True)
    cm, mx, se = row_stats_chunkmax(torch.from_numpy(x))  # a CPU tensor: the plain version
    assert cm.shape == (R, V // 128) and mx.shape == (R,) and se.shape == (R,)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    np.testing.assert_array_equal(mx.numpy(), np.asarray(jmx))
    np.testing.assert_allclose(se.numpy(), np.asarray(jse), rtol=1e-6)


def test_row_stats_rejects_unaligned_vocab():
    with pytest.raises(ValueError, match="V % 128"):
        row_stats_chunkmax(torch.zeros(2, 1000))


@pytest.mark.parametrize("V", [128256, 151936, 16384, 254, 262144, 128261, 212992, 213120])
def test_select_stats_supported_matches_jax(V):
    assert select_stats_supported(V) == jax_supported(V)


@pytest.mark.parametrize("C", [1, 7, 128, 1002])
@pytest.mark.parametrize("R", [1, 8, 13, 45, 480])
def test_row_plan_covers_every_chunk_once(R, C):
    """The one launch's grid: the parts' chunk ranges [p * per, p * per +
    per) cut [0, C) with none empty (the kernel's launch check), at least
    MIN_CHUNKS chunks a part where there is more than one, and no more
    blocks than fit the card at once while rows are split (the tickets'
    and pairs' scratch holds that many)."""
    sms = 132
    parts, per = row_plan(R, C, sms)
    ranges = [(p * per, min(C, (p + 1) * per)) for p in range(parts)]
    assert all(lo < hi for lo, hi in ranges)
    assert [c for lo, hi in ranges for c in range(lo, hi)] == list(range(C))
    assert -(-C // per) == parts
    if parts > 1:
        assert per >= MIN_CHUNKS and R * parts <= BLOCKS_PER_SM * sms


@pytest.mark.parametrize("R", [8, 13, 45, 480])
def test_row_plan_fills_the_card(R):
    """At (d)'s vocabulary (1002 chunks) every row count that the beam
    loop or the JAX package's selection benchmark gives puts a block on
    every one of the 132 SMs."""
    parts, per = row_plan(R, 1002, 132)
    assert R * parts >= 132


@pytest.mark.parametrize("R,V", [(45, 128 * 1002), (8, 128 * 130), (13, 128 * 7), (3, 128)])
def test_row_stats_split_matches_plain(R, V):
    """The kernel's partition and merge order (row_plan's, and two more
    splits) against the plain version: maxima exact, the normaliser at
    rtol 1e-6."""
    x = torch.from_numpy((np.random.RandomState(R + V).randn(R, V) * 4).astype(np.float32))
    C = V // 128
    cm, mx, se = row_stats_chunkmax_plain(x)
    for parts, per in {row_plan(R, C, 132), (1, C), (-(-C // max(1, C // 3)), max(1, C // 3))}:
        scm, smx, sse = row_stats_chunkmax_split(x, parts, per)
        assert torch.equal(scm, cm) and torch.equal(smx, mx)
        np.testing.assert_allclose(sse.numpy(), se.numpy(), rtol=1e-6)


@pytest.mark.parametrize("shape,k", [((2, 15, 128256), 30), ((3, 4, 16384), 8), ((1, 2, 1280), 8)])
def test_topk_chunked_with_maxima_matches_jax(shape, k):
    """With maxima given, short rows (1280 <= 4 * k * 128) take the prefilter
    too, as in the JAX package."""
    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    cm = x.reshape(*shape[:-1], -1, 128).max(-1)
    jv, ji = jax_topk_chunked(jnp.asarray(x), k, chunk_maxima=jnp.asarray(cm))
    v, i = topk_chunked(torch.from_numpy(x), k, chunk_maxima=torch.from_numpy(cm))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))


def test_topk_chunked_maxima_need_aligned_vocab():
    x = torch.zeros(1, 1000)
    with pytest.raises(ValueError, match="V % chunk"):
        topk_chunked(x, 4, chunk_maxima=torch.zeros(1, 8))


def _jax_beam(select_kernel, W, K, V, max_new, B):
    """The token-dependent synthetic step of tests/test_select_kernel.py:63-87."""

    def step_fn(state, new_tok, flat_idx, t):
        shift = (new_tok[..., None].astype(jnp.float32) % 97) * 0.013
        return W[t][None, None, :] + shift, state

    return np.asarray(jax_beam_loop(
        init_logits=jnp.broadcast_to(W[0][None], (B, W.shape[1])), state=(), step_fn=step_fn,
        num_beams=K, vocab_size=V, max_new=max_new, eos_id=1, pad_id=0,
        select_kernel=select_kernel))


def _torch_beam(select_kernel, W, K, V, max_new, B):
    Wt = torch.from_numpy(W)

    def step_fn(state, new_tok, flat_idx, t):
        shift = (new_tok[..., None].float() % 97) * 0.013
        return Wt[t][None, None, :] + shift, state

    out = beam_loop(init_logits=Wt[0][None].expand(B, V), state=(), step_fn=step_fn,
                    num_beams=K, vocab_size=V, max_new=max_new, eos_id=1, pad_id=0,
                    select_kernel=select_kernel)
    return out.tokens.numpy()


def test_beam_loop_select_kernel_matches_jax():
    K, V, max_new, B = 4, 16384, 6, 2
    W = (np.random.RandomState(11).randn(8, V) * 2).astype(np.float32)
    jax_ids = _jax_beam(True, jnp.asarray(W), K, V, max_new, B)
    ids = _torch_beam(True, W, K, V, max_new, B)
    np.testing.assert_array_equal(ids, jax_ids)
    np.testing.assert_array_equal(ids, _torch_beam(False, W, K, V, max_new, B))


@pytest.mark.parametrize("vocab", [128261, 512, 262144])
def test_beam_search_select_kernel_rejects_unsupported_vocab(vocab):
    """The flagship's unaligned 128261, the tiny model's 512 (under the JAX
    opt-in's 16384) and a vocabulary over its VMEM limit never quietly take
    the plain selection when the kernel was asked for."""
    import dataclasses

    from omni_avsr_tpu_torch.models.omni import flagship

    cfg = dataclasses.replace(flagship(tiny=True, dtype=torch.float32).cfg.llm, vocab_size=vocab)
    with pytest.raises(ValueError, match=f"vocabulary {vocab}"):
        beam_search({}, cfg, torch.zeros(1, 16, cfg.hidden_size),
                    key_valid=torch.ones(1, 16, dtype=torch.bool), num_beams=3, max_new=4,
                    eos_id=1, pad_id=0, select_kernel=True)
