"""Decode quantization: `quantize_for_decode("int8")` of the port gives the
same tree as the JAX package's, with int8 codes and f32 scales
bit-identical; the int8 `linear` matches the JAX one."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omni_avsr_tpu_torch.bridge import init_params, params_from_numpy
from omni_avsr_tpu_torch.models.omni import flagship


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v


def _numpy_tree(params):
    return {k: (_numpy_tree(v) if isinstance(v, dict) else v.numpy()) for k, v in params.items()}


def test_quantize_for_decode_bit_identical():
    from omni_avsr_tpu.ops.quant import quantize_for_decode as jq
    from omni_avsr_tpu_torch.ops.quant import quantize_for_decode

    model = flagship(tiny=True, dtype=torch.float32)
    tree = _numpy_tree(init_params(model.cfg, torch.Generator().manual_seed(3), "cpu",
                                   frozen_dtype=torch.float32))
    # eagerly, as the JAX Transcriber calls it: under jit XLA rewrites the
    # scale's division by 127 into a multiply, 1 ulp off in some scales
    ref = dict(_flat(jax.device_get(jq(jax.tree_util.tree_map(jnp.asarray, tree), "int8"))))
    ours = dict(_flat(quantize_for_decode(params_from_numpy(tree, "cpu"), "int8")))
    assert ours.keys() == ref.keys()
    n_int8 = 0
    for path, r in ref.items():
        o = ours[path].numpy()
        assert o.dtype == r.dtype and o.shape == r.shape, path
        np.testing.assert_array_equal(o, r, err_msg=path)
        n_int8 += o.dtype == np.int8
    # LLM q|k|v, o, gate|up, down + lm_head; Whisper and AV-HuBERT layer stacks
    assert n_int8 == 5 + 6 + 6
    assert "llm.layers.attn.qkv.w" in ours and "llm.layers.mlp.gateup.s" in ours


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_linear(dtype):
    from omni_avsr_tpu.models.common import linear as jlinear
    from omni_avsr_tpu.ops.quant import quantize_per_channel as jqpc
    from omni_avsr_tpu_torch.models.common import linear
    from omni_avsr_tpu_torch.ops.quant import quantize_per_channel

    rng = np.random.RandomState(4)
    w = rng.randn(48, 40).astype(np.float32)
    b = rng.randn(40).astype(np.float32)
    x = rng.randn(3, 5, 48).astype(np.float32)
    jleaf = {**jqpc(jnp.asarray(w)), "b": jnp.asarray(b)}
    tleaf = {**quantize_per_channel(torch.from_numpy(w)), "b": torch.from_numpy(b)}
    np.testing.assert_array_equal(tleaf["w"].numpy(), np.asarray(jleaf["w"]))
    np.testing.assert_array_equal(tleaf["s"].numpy(), np.asarray(jleaf["s"]))
    ref = np.asarray(jlinear(jnp.asarray(x).astype(dtype), jleaf).astype(jnp.float32))
    ours = linear(torch.from_numpy(x).to(getattr(torch, dtype)), tleaf).float().numpy()
    # f32: the same f32 products; bf16: one bf16 rounding of the output
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(ours, ref, atol=tol, rtol=tol)
