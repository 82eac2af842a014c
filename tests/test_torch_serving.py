"""The port's serving configurations end to end against the JAX package, at
the tiny flagship widths: beam 15, 32 new tokens, the ancestor route of
beam attention (`OMNI_BEAM_ATTN=kernel`), in f32 on both sides
(tests/torch_parity.py::jax_in_f32; see tests/test_torch_slice.py).

  - pad30s + int8: the default 30 s Whisper window (T = 1500 in the audio
    tower), one clip of 256 frames, so AV-HuBERT runs at the length where
    the card takes the flash kernel;
  - bucket + int4: the packed-int4 LLM (B6's plain version here, the JAX
    package's Pallas kernel in interpret mode there), int8 towers.

Also: the port's flagship configuration equals the JAX package's field by
field, the 30 s window included.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omni_avsr_tpu_torch.bridge import params_from_numpy
from omni_avsr_tpu_torch.models.omni import flagship
from omni_avsr_tpu_torch.serve import Transcriber, pad_batch
from tests.torch_parity import clips, jax_in_f32, jax_tiny_flagship, jax_tiny_params


def _assert_same_config(ours, ref, path="cfg"):
    """Every field of the port's dataclass equals the JAX one's."""
    for f in dataclasses.fields(ours):
        o, r = getattr(ours, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(o):
            _assert_same_config(o, r, f"{path}.{f.name}")
        else:
            assert o == r, (f"{path}.{f.name}", o, r)


@pytest.mark.parametrize("tiny", [True, False])
def test_flagship_config_matches_jax(tiny):
    from __graft_entry__ import _flagship

    ref = _flagship(tiny=tiny)
    ours = flagship(tiny=tiny)
    assert ours.cfg.whisper_input_mode == ref.cfg.whisper_input_mode == "pad30s"
    _assert_same_config(ours.cfg, ref.cfg)
    assert ours.prompt_ids.keys() == ref.prompt_ids.keys()
    for m in ours.prompt_ids:
        np.testing.assert_array_equal(np.asarray(ours.prompt_ids[m]), np.asarray(ref.prompt_ids[m]))
    assert flagship(tiny=tiny, whisper_input_mode="bucket").cfg.whisper_input_mode == "bucket"


@pytest.mark.parametrize("mode,quantize,lengths", [
    ("pad30s", "int8", (256, 40)),
    ("bucket", "int4", (40, 33, 48)),
], ids=["pad30s-int8", "bucket-int4"])
def test_transcriber_matches_jax(monkeypatch, mode, quantize, lengths):
    from omni_avsr_tpu.serve import Transcriber as JaxTranscriber

    jax_in_f32(monkeypatch)
    monkeypatch.setenv("OMNI_BEAM_ATTN", "kernel")
    jm = jax_tiny_flagship(bucket=mode == "bucket")
    params = jax_tiny_params(jm)
    items = clips(lengths, seed=3)
    batch, trim = pad_batch(items, "audiovisual")
    if mode == "pad30s":
        assert batch["video"].shape[1] >= 256  # AV-HuBERT's flash gate on the card

    jt = JaxTranscriber(jm, jax.tree_util.tree_map(jnp.asarray, params), num_beams=15,
                        quantize=quantize)
    jfn = jt.engine._decode_fn("audiovisual", 4, 2, trim, 15, 32)
    jax_ids = np.asarray(jfn(jt.params, {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.PRNGKey(0)))

    pm = flagship(tiny=True, dtype=torch.float32, whisper_input_mode=mode)
    pt = Transcriber(pm, params_from_numpy(params, "cpu"), num_beams=15, quantize=quantize,
                     device="cpu")
    if quantize == "int4":
        head = pt.params["llm"]["lm_head"]  # packed int4, in B6's card layout
        assert "w4" not in head and head["w4c"].dtype == torch.int8
        fc1 = pt.params["whisper"]["layers"]["fc1"]  # int8 towers, in B2's card layout
        assert "w" not in fc1 and fc1["wc"].dtype == torch.int8
    ids = pt.decode_ids(batch, "audiovisual", 4, 2, trim, 15).numpy()
    np.testing.assert_array_equal(ids, jax_ids)
    assert 1 <= pt.last_decode_steps <= 32
    assert (ids != pm.tok.pad_id).any()


def test_beam_search_past_64_beams_matches_jax(monkeypatch):
    """65 beams, more than one 64-bit live-beam mask word of B1: the port's
    ancestor route (B1's plain version here) gives the JAX package's tokens,
    whose CPU default is the XLA reorder route (no `OMNI_BEAM_ATTN`)."""
    from omni_avsr_tpu.serve import Transcriber as JaxTranscriber

    jax_in_f32(monkeypatch)
    monkeypatch.delenv("OMNI_BEAM_ATTN", raising=False)
    jm = jax_tiny_flagship()
    params = jax_tiny_params(jm)
    items = clips((40, 33), seed=4)
    batch, trim = pad_batch(items, "audiovisual")
    jt = JaxTranscriber(jm, jax.tree_util.tree_map(jnp.asarray, params), num_beams=65,
                        quantize="int8")
    jfn = jt.engine._decode_fn("audiovisual", 4, 2, trim, 65, 32)
    jax_ids = np.asarray(jfn(jt.params, {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.PRNGKey(0)))

    pm = flagship(tiny=True, dtype=torch.float32, whisper_input_mode="bucket")
    pt = Transcriber(pm, params_from_numpy(params, "cpu"), num_beams=65, quantize="int8",
                     device="cpu")
    ids = pt.decode_ids(batch, "audiovisual", 4, 2, trim, 65).numpy()
    np.testing.assert_array_equal(ids, jax_ids)
    assert (ids != pm.tok.pad_id).any()
