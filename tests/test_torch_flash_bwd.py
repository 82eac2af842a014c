"""The port's trainable flash attention (B3 forward with lse, B4 backward)
against the JAX package's `flash_attention_trainable` in interpret mode,
at the shapes of tests/test_flash_bwd.py, and the port's plain backward
against torch.autograd through its plain forward.

On the CPU the port takes both plain versions, so this holds their math
(masks, lse, GQA group sums, the dropout keep mask) against the TPU
kernels'. The loss is sum(out * w) with a fixed ramp w, as in
tests/test_flash_bwd.py. Tolerance atol 2e-3 / rtol 1e-3, that test's: f32
on both sides, sums in other orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omni_avsr_tpu_torch.ops.flash_attention import flash_attention_plain
from omni_avsr_tpu_torch.ops.flash_attention_bwd import (
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_trainable,
)

TOL = dict(atol=2e-3, rtol=1e-3)


def _inputs(B, T, S, Hq, Hkv, D, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * 0.5).astype(np.float32)
            for shape in ((B, T, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]


def _ramp(shape):
    return (np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape) * 1e-3)


def _jax_grads(q, k, v, **kw):
    from omni_avsr_tpu.ops.flash_attention_bwd import flash_attention_trainable as jax_fa

    w = jnp.asarray(_ramp(q.shape))

    def loss(q, k, v):
        out = jax_fa(q, k, v, block_q=128, block_k=128, interpret=True, **kw)
        return jnp.sum(out.astype(jnp.float32) * w)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _torch_grads(fn, q, k, v):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fn(*ts)
    (out.float() * torch.from_numpy(_ramp(q.shape))).sum().backward()
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("T,Hq,Hkv,D,causal,lens,rate", [
    (256, 4, 4, 64, False, None, 0.0),
    (200, 4, 2, 64, True, None, 0.0),      # GQA + causal + unaligned
    (128, 8, 8, 128, True, None, 0.0),
    (128, 2, 2, 64, False, (128, 70), 0.0),  # key lengths
    (200, 4, 2, 64, True, (200, 133), 0.1),  # hash dropout, GQA, causal, lengths
], ids=["T256", "T200-gqa-causal", "T128-D128-causal", "lengths", "dropout"])
def test_trainable_grads_match_jax(T, Hq, Hkv, D, causal, lens, rate):
    B, seed = 2, 20261017
    q, k, v = _inputs(B, T, T, Hq, Hkv, D, seed=T + Hq + D)
    jlens = jnp.asarray(lens, jnp.int32) if lens else None
    jkw = dict(causal=causal, kv_lengths=jlens, dropout_rate=rate,
               dropout_seed=jnp.int32(seed) if rate else None)
    want = _jax_grads(q, k, v, **jkw)
    tlens = torch.tensor(lens, dtype=torch.int32) if lens else None
    got = _torch_grads(lambda q, k, v: flash_attention_trainable(
        q, k, v, causal=causal, kv_lengths=tlens, dropout_rate=rate,
        dropout_seed=seed if rate else None), q, k, v)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("T,S,Hq,Hkv,D,causal,lens,rate", [
    (70, 70, 4, 4, 64, False, None, 0.0),
    (50, 50, 8, 2, 64, True, (50, 31), 0.0),
    (40, 56, 4, 2, 128, False, (56, 9), 0.25),
])
def test_plain_bwd_matches_autograd(T, S, Hq, Hkv, D, causal, lens, rate):
    """The plain backward against autograd through the plain forward: the
    dsum shortcut, the group sums and the dropout scaling."""
    B = 2
    q, k, v = _inputs(B, T, S, Hq, Hkv, D, seed=S + D)
    tlens = torch.tensor(lens, dtype=torch.int32) if lens else None
    kw = dict(causal=causal, kv_lengths=tlens, dropout_rate=rate,
              dropout_seed=99 if rate else None)
    want = _torch_grads(lambda q, k, v: flash_attention_plain(q, k, v, **kw), q, k, v)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    do = torch.from_numpy(_ramp(q.shape))
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(tq, tk, tv, o, do, lse, **kw)
    assert flash_attention_bwd.launches == before  # CPU tensors: the plain version
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-4)
    plain = flash_attention_bwd_plain(tq, tk, tv, o, do, lse, **kw)
    for g, p in zip(got, plain):
        torch.testing.assert_close(g, p, atol=0, rtol=0)
