"""The serving slice of the port end to end against the JAX package, at the
tiny flagship widths (`__graft_entry__._flagship(tiny=True)`, bucketed
Whisper window): int8 decode weights, beam 15, 32 new tokens, the ancestor
route of beam attention (`OMNI_BEAM_ATTN=kernel`, the Pallas kernel in
interpret mode on the JAX side, the plain version on the port's).

Compared in f32: both sides would otherwise round to bf16 at different
places (XLA keeps fused intermediates in f32, eager torch rounds after each
op), and with random weights a one-ulp difference can reorder two beam
candidates whose scores are that close. The JAX package's serving path is
redirected to f32 for the test (tests/torch_parity.py::jax_in_f32); the
port runs with its compute dtype set to f32.

Also here: the port and chip_smoke.py import nothing of JAX or of the JAX
package.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omni_avsr_tpu_torch.bridge import params_from_numpy
from omni_avsr_tpu_torch.models.omni import flagship
from omni_avsr_tpu_torch.serve import Transcriber, pad_batch
from tests.torch_parity import clips, jax_in_f32, jax_tiny_flagship, jax_tiny_params

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_model_and_params():
    model = jax_tiny_flagship()
    return model, jax_tiny_params(model)


def test_transcriber_matches_jax(monkeypatch, jax_model_and_params):
    from omni_avsr_tpu.serve import Transcriber as JaxTranscriber

    jax_in_f32(monkeypatch)
    monkeypatch.setenv("OMNI_BEAM_ATTN", "kernel")
    jm, params = jax_model_and_params
    items = clips((40, 33, 48))
    jt = JaxTranscriber(jm, jax.tree_util.tree_map(jnp.asarray, params), num_beams=15,
                        quantize="int8")
    jax_text = jt.transcribe_many(items)

    pm = flagship(tiny=True, dtype=torch.float32, whisper_input_mode="bucket")
    pt = Transcriber(pm, params_from_numpy(params, "cpu"), num_beams=15, quantize="int8",
                     device="cpu")
    assert pt.max_new == 32
    assert pt.transcribe_many(items) == jax_text
    assert 1 <= pt.last_decode_steps <= 32

    batch, trim = pad_batch(items, "audiovisual")
    jfn = jt.engine._decode_fn("audiovisual", 4, 2, trim, 15, 32)
    jax_ids = np.asarray(jfn(jt.params, {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.PRNGKey(0)))
    ids = pt.decode_ids(batch, "audiovisual", 4, 2, trim, 15).numpy()
    np.testing.assert_array_equal(ids, jax_ids)


def test_llm_prefill_and_decode_step(jax_model_and_params):
    """Prefill over a prefix with gaps, then one beam step on the ancestor
    cache (every layer through beam_decode_attention), int8 weights, f32."""
    import omni_avsr_tpu.models.llm as jl
    from omni_avsr_tpu.ops.quant import quantize_for_decode as jq

    import omni_avsr_tpu_torch.models.llm as tl
    from omni_avsr_tpu_torch import config as tcfg

    jm, params = jax_model_and_params
    cfg = jm.cfg.llm
    tcfg_llm = flagship(tiny=True).cfg.llm
    assert tcfg_llm == tcfg.LLMConfig(**{f: getattr(cfg, f) for f in tcfg.LLMConfig.__dataclass_fields__
                                         if f != "lora"}, lora=tcfg_llm.lora)
    llm = jax.device_get(jq({"llm": jax.tree_util.tree_map(jnp.asarray, params["llm"])}, "int8")["llm"])
    B, P, K, N, step = 2, 16, 3, 8, 3
    rng = np.random.RandomState(5)
    emb = (rng.randn(B, P, cfg.hidden_size) * 0.5).astype(np.float32)
    valid = rng.rand(B, P) < 0.75
    valid[:, 0] = True
    positions = (np.cumsum(valid, axis=1) - 1).astype(np.int32)
    last = np.array([P - 1 - np.argmax(valid[b, ::-1]) for b in range(B)], np.int32)
    anc = rng.randint(0, K, (B, K, N)).astype(np.int32)
    flat_idx = (rng.randint(0, K, (B, K)) + np.arange(B)[:, None] * K).reshape(-1)
    tok_emb = (rng.randn(B * K, 1, cfg.hidden_size) * 0.5).astype(np.float32)
    n_valid = np.repeat(valid.sum(axis=1), K).astype(np.int32)

    def jax_step(llm, emb, valid, positions, last, anc, flat_idx, tok_emb, n_valid):
        cache = jl.KVCache.create(cfg, B, P, dtype=jnp.float32)
        logits0, cache = jl.llm_prefill_masked(llm, cfg, emb, valid, positions, last, cache,
                                               "audiovisual")
        cache = jl.AncSplitCache.from_prefill(cache, P, K, N)
        anc = jl.update_ancestors(anc, flat_idx, jnp.int32(step), K)
        logits, _ = jl.llm_decode_step_beam_anc(llm, cfg, tok_emb, jnp.int32(step), n_valid,
                                                valid, cache, anc, K, "audiovisual")
        return logits0, logits, anc

    jl0, jl1, janc = jax.jit(jax_step)(jax.tree_util.tree_map(jnp.asarray, llm), *map(
        jnp.asarray, (emb, valid, positions, last, anc, flat_idx, tok_emb, n_valid)))

    tllm = params_from_numpy(llm, "cpu")
    t = lambda a: torch.from_numpy(np.asarray(a))
    cache = tl.KVCache.create(tcfg_llm, B, P, dtype=torch.float32)
    l0, cache = tl.llm_prefill_masked(tllm, tcfg_llm, t(emb), t(valid), t(positions).long(),
                                      t(last).long(), cache, "audiovisual")
    cache = tl.AncSplitCache.from_prefill(cache, P, K, N)
    tanc = tl.update_ancestors(t(anc), t(flat_idx).long(), step, K)
    np.testing.assert_array_equal(tanc.numpy(), np.asarray(janc))
    l1, _ = tl.llm_decode_step_beam_anc(tllm, tcfg_llm, t(tok_emb), step, t(n_valid).long(),
                                        t(valid), cache, tanc, K, "audiovisual")
    np.testing.assert_allclose(l0.numpy(), np.asarray(jl0), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(l1.numpy(), np.asarray(jl1), atol=1e-4, rtol=1e-4)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("target", ["omni_avsr_tpu_torch", "chip_smoke.py"])
def test_no_jax_imports(target):
    files = sorted((ROOT / target).rglob("*.py")) if target.endswith("torch") else [ROOT / target]
    assert files
    if target.endswith("torch"):  # the walk reaches every module, the training slice's too
        names = {str(f.relative_to(ROOT / target)) for f in files}
        assert {"train/engine.py", "train/state.py", "train/optim.py", "train/checkpoint.py",
                "ops/flash_attention_bwd.py", "decode/decoding.py", "ops/select_topk.py",
                "ops/conv_block.py"} <= names
        # and the registry slice's: the model registry, `registry_model`, the
        # tokenizer, rope, the eval noise branch and the single-request API
        assert {"config.py", "models/omni.py", "data/tokenizer.py", "ops/rope.py",
                "ops/augment.py", "serve.py", "bridge.py"} <= names
        # and the CLI slice's: the data layer, WER/BLEU, the converters, the CLIs
        assert {"cli/common.py", "cli/eval_omni.py", "cli/train_omni.py",
                "convert/common.py", "convert/whisper_torch.py", "convert/avhubert_torch.py",
                "convert/llm_torch.py", "convert/omni_ckpt.py",
                "data/dataset.py", "data/batching.py", "data/noise.py", "data/synthetic.py",
                "data/datamodule.py", "utils/native.py", "utils/metrics.py",
                "utils/logging.py", "utils/profiling.py"} <= names
        # and the serving and baseline slice's
        assert {"cli/serve_http.py", "cli/train_llama_avsr.py", "cli/eval_llama_avsr.py",
                "cli/verify_parity.py"} <= names
        # and the raw-clip slice's: the mouth-ROI chain, the detectors, their
        # converter and the preparation CLIs
        assert {"preprocess/mean_face.py", "preprocess/video_process.py",
                "preprocess/retinaface.py", "preprocess/fan.py", "preprocess/detector.py",
                "preprocess/noise_prep.py", "convert/detector_torch.py",
                "cli/preprocess_video.py", "cli/prepare_dataset.py", "cli/make_noise.py"} <= names
        # and the parallelism slice's: meshes, start-up, specs, collectives,
        # the pipeline and the launcher
        assert {"parallel/__init__.py", "parallel/mesh.py", "parallel/distributed.py",
                "parallel/partitioning.py", "parallel/pipeline.py", "parallel/collectives.py",
                "parallel/launch.py"} <= names
        # and the last module slice's: lightweight and dynamic convolutions,
        # the subword vocabularies, their CLI and the offline tokenizer
        assert {"ops/lightconv.py", "data/subword.py", "cli/gen_subword.py",
                "data/local_tokenizer.py", "utils/profiling.py"} <= names
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "omni_avsr_tpu", "__graft_entry__"), (f, name)


def test_preprocessing_needs_no_opencv():
    """The mouth-ROI chain runs where OpenCV is not installed: the chain,
    the detector converter and the preparation CLIs import none (mp4 reading and writing
    stay in data/dataset.py and data/synthetic.py, imported only there)."""
    port = ROOT / "omni_avsr_tpu_torch"
    files = sorted((port / "preprocess").rglob("*.py")) + [
        port / "convert" / "detector_torch.py", port / "cli" / "preprocess_video.py",
        port / "cli" / "prepare_dataset.py", port / "cli" / "make_noise.py"]
    assert len(files) >= 10
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in ("cv2", "jax", "omni_avsr_tpu"), (f, name)


def _kernels_line_entries():
    """(key, wrapper name, source, replaces) of each `entry(...)` call that
    builds chip_smoke.py's `kernels` line, read from its source."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    found = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "entry":
            key, name, source, replaces = (a.value for a in node.args[:4])
            found[key] = (name, source, replaces)
    return found


@pytest.mark.parametrize("key", ["B1", "B2", "B3", "B4", "B5", "B6", "B7", "MOE"])
def test_kernels_line_names_the_kernel_source(key):
    """Each kernel of chip_smoke.py's `kernels` line names the csrc file
    that its wrapper builds and loads, that file defines the wrapper's C
    entry point, and `replaces` points at the TPU kernel's `def` (for the
    port's own MOE routing kernel, at the JAX function it stands in for)."""
    import re

    entries = _kernels_line_entries()
    assert sorted(entries) == ["B1", "B2", "B3", "B4", "B5", "B6", "B7", "MOE"]
    name, source, replaces = entries[key]
    # the ops module that defines the wrapper, and what it loads
    modules = [p for p in sorted((ROOT / "omni_avsr_tpu_torch" / "ops").glob("*.py"))
               if re.search(rf"^def {name}\(", p.read_text(), re.M)]
    assert len(modules) == 1, (name, modules)
    loads = re.findall(r'load\("(\w+)"\)\.(\w+)', modules[0].read_text())
    assert len(loads) == 1, loads
    stem, symbol = loads[0]
    assert source == f"omni_avsr_tpu_torch/csrc/{stem}.cu"
    cu = ROOT / source
    assert cu.exists(), source
    assert re.search(rf'extern "C" int {symbol}\(', cu.read_text()), (source, symbol)
    path, line = replaces.split(":")
    text = (ROOT / path).read_text().splitlines()[int(line) - 1]
    want = r"def _topk_balanced_assignment\(" if key == "MOE" else r"def _\w*kernel\("
    assert re.match(want, text), (replaces, text)
