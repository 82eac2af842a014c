"""The layer-streaming quantiser (`ops/quant.py::quantize_for_card`) and the
serving trees built through it, on the CPU:

  - bit-identical to `arrange_for_card(quantize_for_decode(...))` for int8
    and int4, the LLM only and with the towers, on a tiny Qwen-style tree
    (q/k/v biases, untied lm_head, a vocabulary that is not a multiple of
    the card layout's 128 columns) and a tiny Llama tree (tied), the lm_head
    quantised in several runs of columns; fed from leaves where the caller
    put them ("host") and from leaves already placed ("device": on the
    CPU the same device; tests/test_torch_cuda.py runs both on the card),
    and with a placement that casts every leaf first;
  - `Transcriber(quantize=...)` given a host tree decodes token-identical
    to one given a placed tree;
  - an MoE tree with a quantize mode raises, naming the JAX package's limit;
  - `bridge.init_serving_params` draws the card tree layer by layer: the
    leaves, shapes and dtypes of the Transcriber's own int8 / int4 tree,
    and it serves.
"""

import dataclasses

import pytest
import torch

from omni_avsr_tpu_torch.bridge import init_params, init_serving_params
from omni_avsr_tpu_torch.data.tokenizer import synthetic_tokenizer
from omni_avsr_tpu_torch.models.omni import OmniAVSR, flagship
from omni_avsr_tpu_torch.ops import quant
from omni_avsr_tpu_torch.ops.quant import (arrange_for_card, place_tree, quantize_for_card,
                                           quantize_for_decode)
from omni_avsr_tpu_torch.serve import Transcriber, placer
from tests.torch_parity import clips


def _model(family: str, dtype=torch.float32, **llm_changes) -> OmniAVSR:
    m = flagship(tiny=True, dtype=dtype, whisper_input_mode="bucket")
    tok = m.tok
    if family == "qwen":  # 393 + 7 specials: 400 columns, not a multiple of 128
        tok = synthetic_tokenizer("qwen", base_vocab=393)
        llm_changes = dict(family="qwen", attention_bias=True, tie_word_embeddings=False,
                           vocab_size=tok.vocab_size, rope_scaling_factor=None, **llm_changes)
    return OmniAVSR(dataclasses.replace(m.cfg, llm=dataclasses.replace(m.cfg.llm, **llm_changes)),
                    tok, dtype=dtype)


def _assert_same(want, got, path=""):
    assert want.keys() == got.keys(), (path, sorted(want), sorted(got))
    for k in want:
        if isinstance(want[k], dict):
            _assert_same(want[k], got[k], f"{path}.{k}")
        else:
            assert want[k].dtype == got[k].dtype and want[k].shape == got[k].shape, f"{path}.{k}"
            assert torch.equal(want[k], got[k]), f"{path}.{k}"


@pytest.mark.parametrize("source", ["host", "device"])
@pytest.mark.parametrize("llm_only", [False, True], ids=["towers", "llm-only"])
@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("family", ["qwen", "llama"])
def test_stream_bit_identical(monkeypatch, family, mode, llm_only, source):
    monkeypatch.setattr(quant, "HEAD_COLUMNS", 128)  # the lm_head in several runs
    m = _model(family)
    params = init_params(m.cfg, torch.Generator().manual_seed(0), "cpu")
    if family == "qwen":
        assert "b" in params["llm"]["layers"]["attn"]["q"] and "lm_head" in params["llm"]
    place = lambda path, t: t.to("cpu")  # noqa: E731
    src = params if source == "host" else place_tree(params, place)
    want = arrange_for_card(quantize_for_decode(place_tree(params, place), mode, llm_only))
    got = quantize_for_card(src, mode, place, llm_only=llm_only)
    _assert_same(want, got)
    key = "wc" if mode == "int8" else "w4c"
    assert key in got["llm"]["layers"]["attn"]["qkv"] and key in got["llm"]["lm_head"]
    assert ("wc" in got["whisper"]["layers"]["fc1"]) != llm_only


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_stream_casts_before_quantising(mode):
    """With a placement that casts every leaf (a model whose whole LLM
    trains), the codes are those of the cast weights, as the whole-tree
    path quantises the merged tree."""
    m = _model("qwen")
    params = init_params(m.cfg, torch.Generator().manual_seed(1), "cpu")
    place = placer(torch.bfloat16, "cpu", lambda path: True)
    want = arrange_for_card(quantize_for_decode(place_tree(params, place), mode))
    _assert_same(want, quantize_for_card(params, mode, place))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_transcriber_host_and_placed_trees_decode_alike(mode):
    m = _model("qwen")
    params = init_params(m.cfg, torch.Generator().manual_seed(2), "cpu")
    kw = dict(num_beams=3, max_new_tokens=6, quantize=mode, device="cpu")
    host = Transcriber(m, params, **kw)
    placed = Transcriber(m, place_tree(params, placer(m.dtype, "cpu", m.trainable_predicate())),
                         **kw)
    _assert_same(host.params, placed.params)
    want = arrange_for_card(quantize_for_decode(
        place_tree(params, placer(m.dtype, "cpu", m.trainable_predicate())), mode))
    _assert_same(want, host.params)
    items = clips((40, 33), seed=3)
    assert host.transcribe_many(items) == placed.transcribe_many(items)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_moe_tree_refuses_quantisation(mode):
    m = _model("llama", moe_experts=2)
    params = init_params(m.cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match=r"omni_avsr_tpu/ops/quant.py:251"):
        Transcriber(m, params, quantize=mode, device="cpu")
    with pytest.raises(ValueError, match=r"omni_avsr_tpu/ops/quant.py:251"):
        quantize_for_decode(params, mode)
    Transcriber(m, params, device="cpu")  # unquantised, as the JAX package serves it


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("family", ["qwen", "llama"])
def test_serving_draw_matches_transcriber_tree(family, mode):
    m = _model(family)
    tree = init_serving_params(m.cfg, torch.Generator().manual_seed(0), mode, "cpu")
    served = Transcriber(m, tree, num_beams=3, max_new_tokens=6, device="cpu")
    ref = Transcriber(m, init_params(m.cfg, torch.Generator().manual_seed(0), "cpu"),
                      quantize=mode, device="cpu")

    def shapes(t, p=""):
        out = {}
        for k, v in t.items():
            out.update(shapes(v, f"{p}.{k}") if isinstance(v, dict)
                       else {f"{p}.{k}": (tuple(v.shape), v.dtype)})
        return out

    assert shapes(served.params) == shapes(ref.params)
    texts = served.transcribe_many(clips((40, 33), seed=4))
    assert len(texts) == 2 and all(isinstance(s, str) for s in texts)
