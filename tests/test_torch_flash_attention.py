"""Flash attention (B3): the port's plain version against the JAX package's
Pallas kernel run in interpret mode, at the JAX tests' own tolerance in
f32 (atol 2e-5, rtol 1e-4, `tests/test_flash_attention.py:33`); the
dropout keep mask bit for bit against `_keep_mask`; and the wrapper's
routing on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omni_avsr_tpu.ops.flash_attention import _keep_mask, flash_attention as jax_flash
from omni_avsr_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
    keep_mask,
)

TOL = dict(atol=2e-5, rtol=1e-4)


def _qkv(B, T, S, Hq, Hkv, D, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, T, Hq, D) * 0.5).astype(np.float32)
    k = (rng.randn(B, S, Hkv, D) * 0.5).astype(np.float32)
    v = (rng.randn(B, S, Hkv, D) * 0.5).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", [
    dict(B=2, T=96, S=96, Hq=4, Hkv=4, D=64),                             # bidirectional
    dict(B=1, T=80, S=80, Hq=2, Hkv=2, D=64, causal=True),                # causal
    dict(B=2, T=64, S=72, Hq=2, Hkv=2, D=64, lens=(72, 40)),              # key lengths
    dict(B=2, T=72, S=72, Hq=2, Hkv=2, D=64, causal=True, lens=(50, 72)),  # causal + lengths
    dict(B=2, T=48, S=56, Hq=4, Hkv=2, D=64, lens=(56, 17)),              # GQA 4/2
    dict(B=1, T=40, S=64, Hq=4, Hkv=2, D=128, causal=True),               # D 128, GQA
    dict(B=2, T=64, S=64, Hq=2, Hkv=1, D=64, lse=True, lens=(64, 30)),    # lse
    dict(B=1, T=33, S=33, Hq=4, Hkv=4, D=128, lse=True, causal=True),     # lse, D 128
], ids=["bidir", "causal", "lengths", "causal_lengths", "gqa", "d128", "lse", "lse_d128"])
def test_plain_matches_jax_kernel(case):
    B, T, S, Hq, Hkv, D = (case[k] for k in ("B", "T", "S", "Hq", "Hkv", "D"))
    causal, lse = case.get("causal", False), case.get("lse", False)
    lens = np.asarray(case["lens"], np.int32) if "lens" in case else None
    q, k, v = _qkv(B, T, S, Hq, Hkv, D, seed=T + S + D)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                    kv_lengths=None if lens is None else jnp.asarray(lens),
                    interpret=True, return_lse=lse)
    ours = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           causal=causal,
                           kv_lengths=None if lens is None else torch.from_numpy(lens),
                           return_lse=lse)
    if lse:
        (ref, ref_lse), (ours, ours_lse) = ref, ours
        assert ours_lse.shape == (B * Hq, T) and ours_lse.dtype == torch.float32
        np.testing.assert_allclose(ours_lse.numpy(), np.asarray(ref_lse), **TOL)
    assert ours.shape == (B, T, Hq, D)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("scale", [0.0, -0.125, -1.0])
def test_plain_matches_jax_kernel_at_scale_zero_and_below(scale):
    """Any finite scale, as the JAX kernel takes it: at 0 the softmax is
    uniform over the live keys, below 0 it favours the smallest logits;
    masked keys (causal, key lengths) stay out of both, lse included."""
    B, T, S, H, D = 2, 48, 56, 2, 64
    q, k, v = _qkv(B, T, S, H, H, D, seed=5)
    lens = np.asarray([56, 21], np.int32)
    ref, ref_lse = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
                             causal=True, kv_lengths=jnp.asarray(lens), interpret=True,
                             return_lse=True)
    ours, ours_lse = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), scale=scale, causal=True,
                                     kv_lengths=torch.from_numpy(lens), return_lse=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(ours_lse.numpy(), np.asarray(ref_lse), **TOL)


@pytest.mark.parametrize("seed,h,q_start,k_start,rate", [
    (1234, 0, 0, 0, 0.1),
    (-7, 5, 128, 256, 0.3),
    (2**31 - 1, 63, 1472, 1024, 0.5),
    (0, 17, 64, 0, 0.9),
])
def test_keep_mask_bit_identical(seed, h, q_start, k_start, rate):
    bq, bk, seq_k = 64, 96, 1500
    ref = np.asarray(_keep_mask(jnp.int32(seed), jnp.int32(h), q_start, k_start, bq, bk,
                                seq_k, rate))
    ours = keep_mask(seed, h, q_start, k_start, bq, bk, seq_k, rate).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert 0.0 < ours.mean() < 1.0


@pytest.mark.parametrize("rate,causal", [(0.1, False), (0.5, True)])
def test_dropout_matches_jax_kernel(rate, causal):
    """The same keep mask and the same scaling: `tests/test_flash_dropout.py:64`'s
    2e-5, with lse, which the backward will read."""
    B, T, H, D = 2, 64, 2, 64
    q, k, v = _qkv(B, T, T, H, H, D, seed=11)
    seed = 77
    ref, ref_lse = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                             interpret=True, return_lse=True, dropout_rate=rate,
                             dropout_seed=jnp.int32(seed))
    ours, ours_lse = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                           torch.from_numpy(v), causal=causal, return_lse=True,
                                           dropout_rate=rate, dropout_seed=seed)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(ours_lse.numpy(), np.asarray(ref_lse), **TOL)
    plain = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  causal=causal)
    assert not torch.allclose(ours, plain, atol=1e-3)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(1, 16, 16, 2, 2, 64, 0))
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    assert flash_attention.launches == before
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, flash_attention_plain(q, k, v), atol=0, rtol=0)
