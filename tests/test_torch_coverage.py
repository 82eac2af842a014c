"""The small public functions of the JAX package that the port lacked
until its last module slice, each against its JAX counterpart on the same
seeded inputs: `config.asdict`, `models/common.py::count_params`,
`cast_tree`, `tree_paths`, `stack_layers`, `ops/pooling.py::compressed_len`,
`ops/quant.py::dequantize`,
`ops/attention.py::combine_masks`, `bridge.init_llm` (the shapes of JAX's
`init_llm`), `convert/common.py::conv2d_from_torch` / `conv3d_from_torch`,
`train/state.py::default_trainable_predicate`; and
`train/checkpoint.py::restore_raw` on the port's own `.pt` checkpoints
(the JAX one reads orbax directories).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp


def _tree(seed: int = 0):
    rng = np.random.RandomState(seed)
    return {"a": {"w": rng.randn(3, 4).astype(np.float32), "s": rng.rand(4).astype(np.float32)},
            "codes": rng.randint(-127, 128, (5, 2)).astype(np.int8),
            "b": {"c": {"scale": rng.randn(7).astype(np.float32)}}}


def test_config_asdict_matches_jax():
    import omni_avsr_tpu.config as J
    import omni_avsr_tpu_torch.config as P

    for name in ("llama32_1b", "llama31_8b"):
        assert P.asdict(getattr(P, name)()) == J.asdict(getattr(J, name)())
    assert P.asdict(P.OmniConfig()) == J.asdict(J.OmniConfig())
    assert P.asdict(P.TrainConfig()) == J.asdict(J.TrainConfig())
    assert P.Modality is str and J.Modality is str


def test_tree_utilities_match_jax():
    from omni_avsr_tpu.models import common as J
    from omni_avsr_tpu_torch.bridge import params_from_numpy
    from omni_avsr_tpu_torch.models import common as P

    tree = _tree()
    port = params_from_numpy(tree, "cpu")
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    assert P.count_params(port) == J.count_params(jtree) == 12 + 4 + 10 + 7
    # JAX's tree_map sorts a dict's keys; the port keeps the tree's order
    assert sorted(k for k, _ in P.tree_paths(port)) == [k for k, _ in J.tree_paths(jtree)]
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16)):
        got = dict(P.tree_paths(P.cast_tree(port, dtype)))
        want = dict(J.tree_paths(J.cast_tree(jtree, jdtype)))
        for k in want:
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          np.asarray(want[k], np.float32), err_msg=k)
    layers = [_tree(s) for s in range(3)]
    got = P.stack_layers([params_from_numpy(t, "cpu") for t in layers])
    want = J.stack_layers(tuple(jax.tree_util.tree_map(jnp.asarray, t) for t in layers))
    for (kg, g), (kw, w) in zip(sorted(P.tree_paths(got), key=lambda kv: kv[0]),
                                J.tree_paths(want)):
        assert kg == kw and g.shape[0] == 3
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=kg)


@pytest.mark.parametrize("T, rate", [(0, 2), (7, 2), (160, 4), (161, 16), (5, 5)])
def test_compressed_len_matches_jax(T, rate):
    from omni_avsr_tpu.ops.pooling import compressed_len as J
    from omni_avsr_tpu_torch.ops.pooling import compress, compressed_len

    assert compressed_len(T, rate) == J(T, rate)
    if T:
        pooled = compress(torch.zeros(1, T, 4), rate, "avg-pooling")
        assert pooled.shape[1] == compressed_len(T, rate)


def test_dequantize_matches_jax():
    from omni_avsr_tpu.ops import quant as J
    from omni_avsr_tpu_torch.ops import quant as P

    rng = np.random.RandomState(3)
    w = rng.randn(96, 200).astype(np.float32)
    jq = J.quantize_per_channel(jnp.asarray(w))
    q = {k: torch.from_numpy(np.array(v)) for k, v in jq.items()}
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        got = P.dequantize(q, dtype)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(J.dequantize(jq, jdtype), np.float32))


def test_combine_masks_matches_jax():
    from omni_avsr_tpu.ops.attention import combine_masks as J
    from omni_avsr_tpu_torch.ops.attention import combine_masks

    rng = np.random.RandomState(4)
    a, b = rng.rand(2, 1, 5, 5) > 0.3, rng.rand(2, 1, 1, 5) > 0.3
    got = combine_masks(torch.from_numpy(a), None, torch.from_numpy(b))
    want = J(jnp.asarray(a), None, jnp.asarray(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert combine_masks(None, None) is None and J(None, None) is None
    assert torch.equal(combine_masks(torch.from_numpy(a)), torch.from_numpy(a))


def test_init_llm_has_the_jax_shapes():
    from omni_avsr_tpu.models import llm as J
    from omni_avsr_tpu.models.common import tree_paths as jpaths
    from omni_avsr_tpu_torch.bridge import init_llm
    from omni_avsr_tpu_torch.models.common import count_params, tree_paths
    from tests.test_llm import tiny_cfg

    import omni_avsr_tpu_torch.config as port_cfg
    from tests.torch_parity import twin_config

    for cfg in (tiny_cfg(), dataclasses.replace(tiny_cfg(), tie_word_embeddings=False)):
        jt = jax.eval_shape(lambda k: J.init_llm(k, cfg), jax.random.PRNGKey(0))
        pt = init_llm(twin_config(cfg, port_cfg), torch.Generator().manual_seed(0), "cpu",
                      torch.float32)
        assert {k: tuple(v.shape) for k, v in tree_paths(pt)} == \
            {k: tuple(v.shape) for k, v in jpaths(jt)}
        assert count_params(pt) == sum(int(np.prod(v.shape)) for _, v in jpaths(jt))


def test_restore_raw_reads_the_port_checkpoint(tmp_path):
    from omni_avsr_tpu_torch.train.checkpoint import (restore_checkpoint, restore_raw,
                                                      save_checkpoint)
    from omni_avsr_tpu_torch.train.state import TrainState

    trainable = {"lora": {"w": torch.randn(4, 3)}, "proj": {"b": torch.randn(3)}}
    opt = {"count": torch.tensor(2), "mu": {"lora": {"w": torch.zeros(4, 3)}}}
    path = save_checkpoint(str(tmp_path), 7, TrainState(7, trainable, opt))
    raw = restore_raw(path)
    assert set(raw) == {"step", "trainable", "opt_state"} and raw["step"] == 7
    assert torch.equal(raw["trainable"]["lora"]["w"], trainable["lora"]["w"])
    assert raw["trainable"]["lora"]["w"].device.type == "cpu"
    assert not raw["trainable"]["lora"]["w"].requires_grad  # as saved: no TrainState built
    state = restore_checkpoint(path, "cpu")
    assert torch.equal(state.trainable["proj"]["b"], raw["trainable"]["proj"]["b"])


def test_conv_converters_and_trainable_predicate_match_jax():
    from omni_avsr_tpu.convert import common as JC
    from omni_avsr_tpu.train.state import default_trainable_predicate as jax_pred
    from omni_avsr_tpu_torch.convert import common as PC
    from omni_avsr_tpu_torch.train.state import default_trainable_predicate

    g = torch.Generator().manual_seed(5)
    sd = {"c2.weight": torch.randn(8, 3, 3, 5, generator=g), "c2.bias": torch.randn(8, generator=g),
          "c3.weight": torch.randn(4, 2, 3, 5, 7, generator=g)}
    for name in ("conv2d_from_torch", "conv3d_from_torch"):
        prefix = "c2" if name.startswith("conv2d") else "c3"
        got, want = getattr(PC, name)(sd, prefix), getattr(JC, name)(sd, prefix)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    for path in ("llm.layers.lora.audio.down_q.w", "audio_proj.4.fc1.w", "llm.embed.w",
                 "whisper.layers.attn.q.w", "avhubert.layers.lora_q.w"):
        assert default_trainable_predicate(path) == jax_pred(path), path
