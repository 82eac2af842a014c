"""The serving slice with both opt-in kernel routes on, end to end against
the JAX package: the tiny flagship with the LLM at a 16384-token
vocabulary (the smallest the selection-stats kernel B5 takes), int8
decode weights, beam 15, 32 new tokens, through
`Transcriber(select_kernel=True, conv_kernel=True)`.

The JAX side takes the same routes: `OMNI_SELECT_KERNEL=1` (its B5 in
interpret mode, read when the decode function is traced), the ancestor
route of beam attention (`OMNI_BEAM_ATTN=kernel`), and its `fused_conv`
routed through the Pallas kernel B7 in interpret mode
(tests/torch_parity.py::jax_conv_kernel). Both sides run in f32
(tests/torch_parity.py::jax_in_f32); the port's CPU tensors take the
kernels' plain versions.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omni_avsr_tpu_torch.bridge import init_params, params_from_numpy
from omni_avsr_tpu_torch.data.tokenizer import synthetic_tokenizer
from omni_avsr_tpu_torch.models.omni import OmniAVSR, flagship
from omni_avsr_tpu_torch.serve import Transcriber, pad_batch
from tests.torch_parity import (
    clips,
    jax_conv_kernel,
    jax_in_f32,
    jax_tiny_flagship,
    randomize_lora_down,
)

BASE_VOCAB = 16377  # + 7 specials = 16384, a multiple of 128


def _with_vocab(model_cls, model, tok):
    llm = dataclasses.replace(model.cfg.llm, vocab_size=tok.vocab_size)
    return model_cls(dataclasses.replace(model.cfg, llm=llm), tok, **(
        {"dtype": model.dtype} if model_cls is OmniAVSR else {}))


@pytest.fixture(scope="module")
def models_and_params():
    """The JAX and the port's model at the 16384 vocabulary, and one numpy
    f32 tree for both (the port's initialiser, which builds the JAX
    package's shapes, LoRA downs randomised)."""
    from omni_avsr_tpu.data.tokenizer import synthetic_tokenizer as jax_tokenizer
    from omni_avsr_tpu.models.omni import OmniAVSR as JaxOmni

    jm = _with_vocab(JaxOmni, jax_tiny_flagship(), jax_tokenizer("llama", base_vocab=BASE_VOCAB))
    pm = _with_vocab(OmniAVSR, flagship(tiny=True, dtype=torch.float32, whisper_input_mode="bucket"),
                     synthetic_tokenizer("llama", base_vocab=BASE_VOCAB))
    assert jm.cfg.llm.vocab_size == pm.cfg.llm.vocab_size == 16384
    tree = init_params(pm.cfg, torch.Generator().manual_seed(0), "cpu", frozen_dtype=torch.float32)

    def to_numpy(node):
        return {k: (to_numpy(v) if isinstance(v, dict) else v.numpy()) for k, v in node.items()}

    return jm, pm, randomize_lora_down(to_numpy(tree))


def test_transcriber_kernel_routes_match_jax(monkeypatch, models_and_params):
    from omni_avsr_tpu.serve import Transcriber as JaxTranscriber

    jax_in_f32(monkeypatch)
    jax_conv_kernel(monkeypatch)
    monkeypatch.setenv("OMNI_BEAM_ATTN", "kernel")
    monkeypatch.setenv("OMNI_SELECT_KERNEL", "1")
    jm, pm, params = models_and_params
    items = clips((16, 13))
    jt = JaxTranscriber(jm, jax.tree_util.tree_map(jnp.asarray, params), num_beams=15,
                        quantize="int8")
    batch, trim = pad_batch(items, "audiovisual")
    jfn = jt.engine._decode_fn("audiovisual", 4, 2, trim, 15, 32)
    jax_ids = np.asarray(jfn(jt.params, {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.PRNGKey(0)))

    pt = Transcriber(pm, params_from_numpy(params, "cpu"), num_beams=15, quantize="int8",
                     device="cpu", select_kernel=True, conv_kernel=True)
    ids = pt.decode_ids(batch, "audiovisual", 4, 2, trim, 15).numpy()
    np.testing.assert_array_equal(ids, jax_ids)
    assert 1 <= pt.last_decode_steps <= 32
