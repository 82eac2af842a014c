"""Greedy decoding (`num_beams <= 1`) of the port against the JAX engine's
`greedy_decode`, at the tiny flagship widths (bucketed Whisper window),
int8 decode weights, 32 new tokens, the ancestor route of beam attention
with one beam (`OMNI_BEAM_ATTN=kernel`: the Pallas kernel in interpret
mode on the JAX side, the plain version on the port's), in f32 on both
sides (tests/torch_parity.py::jax_in_f32).

Two trees: the untouched random one, where EOS never wins, and one where
the tied EOS embedding row is set to 1.02x the row of a token that greedy
emits, so EOS wins at some step and the rows stop early. A one-beam beam
search differs from greedy exactly there: it files the EOS as a finished
hypothesis and keeps decoding.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omni_avsr_tpu_torch.bridge import params_from_numpy
from omni_avsr_tpu_torch.models.omni import flagship
from omni_avsr_tpu_torch.serve import Transcriber, pad_batch
from tests.torch_parity import clips, jax_in_f32, jax_tiny_flagship, jax_tiny_params


def _jax_greedy(jm, params, batch, trim):
    from omni_avsr_tpu.serve import Transcriber as JaxTranscriber

    jt = JaxTranscriber(jm, jax.tree_util.tree_map(jnp.asarray, params), num_beams=1,
                        quantize="int8")
    fn = jt.engine._decode_fn("audiovisual", 4, 2, trim, 1, 32)
    return jt, np.asarray(fn(jt.params, {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def untouched():
    """The tiny JAX flagship, its tree, a padded batch and the JAX greedy
    ids on the untouched tree."""
    jm = jax_tiny_flagship()
    params = jax_tiny_params(jm)
    items = clips((40, 33, 48), seed=5)
    batch, trim = pad_batch(items, "audiovisual")
    with pytest.MonkeyPatch.context() as mp:
        jax_in_f32(mp)
        mp.setenv("OMNI_BEAM_ATTN", "kernel")
        jt, jax_ids = _jax_greedy(jm, params, batch, trim)
        jax_text = jt.transcribe_many(items)
    return jm, params, items, batch, trim, jax_ids, jax_text


@pytest.mark.parametrize("eos_wins", [False, True], ids=["untouched", "eos-wins"])
def test_greedy_matches_jax(monkeypatch, untouched, eos_wins):
    jm, params, items, batch, trim, jax_ids, jax_text = untouched
    tok = jm.tok
    if eos_wins:
        jax_in_f32(monkeypatch)
        monkeypatch.setenv("OMNI_BEAM_ATTN", "kernel")
        emb = np.array(params["llm"]["embed"]["w"])
        emb[tok.eos_id] = 1.02 * emb[int(jax_ids[0, 1])]
        params = {**params, "llm": {**params["llm"], "embed": {"w": emb}}}
        jt, jax_ids = _jax_greedy(jm, params, batch, trim)
        jax_text = jt.transcribe_many(items)
        assert (jax_ids == tok.eos_id).any()
        assert (jax_ids == tok.pad_id).any()  # some row stopped early
    else:
        assert not (jax_ids == tok.eos_id).any()

    pm = flagship(tiny=True, dtype=torch.float32, whisper_input_mode="bucket")
    pt = Transcriber(pm, params_from_numpy(params, "cpu"), num_beams=1, quantize="int8",
                     device="cpu")
    ids = pt.decode_ids(batch, "audiovisual", 4, 2, trim, 1).numpy()
    np.testing.assert_array_equal(ids, jax_ids)
    stopped = (ids == tok.eos_id).any(axis=1)
    # one decode step per token after the first, up to the last row's EOS
    want_steps = int(np.argmax(ids == tok.eos_id, axis=1).max()) if stopped.all() else 31
    assert pt.last_decode_steps == want_steps
    assert pt.transcribe_many(items, num_beams=1) == jax_text
