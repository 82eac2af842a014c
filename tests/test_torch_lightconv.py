"""Lightweight and dynamic convolutions of the port
(`omni_avsr_tpu_torch/ops/lightconv.py`) against the JAX package's
(`omni_avsr_tpu/ops/lightconv.py`) over tests/test_lightconv.py's cases:
H in {1, 4, 16}, softmax on and off, padding_l in {0, 1, 2} (and causal
K - 1), biases, the K > T causal truncation; the same seeded numpy inputs,
f32, tolerance 1e-5. Both functions' gradients pass
`torch.autograd.gradcheck` in f64 at a tiny size, and bf16 inputs give
bf16 outputs accumulated in f32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("H,softmax,padding_l,bias", [
    (1, False, 2, True), (4, True, 2, True), (4, True, 1, False), (16, False, 0, True),
    (4, True, 3, False),  # causal: padding_l = K - 1 with K 4
])
def test_lightweight_conv_matches_jax(H, softmax, padding_l, bias):
    from omni_avsr_tpu.ops import lightconv as J
    from omni_avsr_tpu_torch.ops import lightconv as P

    rng = np.random.RandomState(0)
    B, T, C, K = 2, 9, 16, 4 if padding_l == 3 else 3
    x = rng.randn(B, T, C).astype(np.float32)
    w = rng.randn(H, K).astype(np.float32)
    b = rng.randn(C).astype(np.float32) if bias else None
    want = J.lightweight_conv(jnp.asarray(x), jnp.asarray(w), padding_l, weight_softmax=softmax,
                              bias=None if b is None else jnp.asarray(b))
    got = P.lightweight_conv(torch.from_numpy(x), torch.from_numpy(w), padding_l,
                             weight_softmax=softmax, bias=None if b is None else torch.from_numpy(b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("H,K,T,softmax,padding_l,biases", [
    (4, 4, 8, True, 3, True), (4, 4, 8, False, 2, False), (4, 4, 8, True, 0, True),
    (1, 3, 8, True, 1, False), (12, 3, 8, False, 2, True),
    (2, 6, 3, True, 5, False),  # K > T, causal: the last T taps after the softmax over K
    (2, 6, 3, True, 2, True),  # K > T, not causal: no truncation
])
def test_dynamic_conv_matches_jax(H, K, T, softmax, padding_l, biases):
    from omni_avsr_tpu.ops import lightconv as J
    from omni_avsr_tpu_torch.ops import lightconv as P

    rng = np.random.RandomState(1)
    B, C = 2, 12
    x = rng.randn(B, T, C).astype(np.float32)
    q = rng.randn(B, T, C).astype(np.float32)
    wl = (rng.randn(C, H * K) * 0.3).astype(np.float32)
    lb = rng.randn(H * K).astype(np.float32) if biases else None
    cb = rng.randn(C).astype(np.float32) if biases else None
    opt = lambda a, f: None if a is None else f(a)  # noqa: E731
    want = J.dynamic_conv(jnp.asarray(x), jnp.asarray(q), jnp.asarray(wl), num_heads=H,
                          kernel_size=K, padding_l=padding_l, weight_softmax=softmax,
                          linear_bias=opt(lb, jnp.asarray), conv_bias=opt(cb, jnp.asarray))
    got = P.dynamic_conv(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(wl),
                         num_heads=H, kernel_size=K, padding_l=padding_l, weight_softmax=softmax,
                         linear_bias=opt(lb, torch.from_numpy), conv_bias=opt(cb, torch.from_numpy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_heads_must_divide_channels():
    from omni_avsr_tpu_torch.ops import lightconv as P

    with pytest.raises(ValueError, match="not divisible by 3 heads"):
        P.lightweight_conv(torch.zeros(1, 4, 8), torch.zeros(3, 3), 2)
    with pytest.raises(ValueError, match="not divisible by 3 heads"):
        P.dynamic_conv(torch.zeros(1, 4, 8), torch.zeros(1, 4, 8), torch.zeros(8, 9), 3, 3, 2)


def test_gradcheck_and_bf16():
    from omni_avsr_tpu_torch.ops import lightconv as P

    rng = np.random.RandomState(2)
    B, T, C, H, K = 1, 5, 4, 2, 3
    f64 = lambda *s: torch.from_numpy(rng.randn(*s)).requires_grad_(True)  # noqa: E731
    x, w, b = f64(B, T, C), f64(H, K), f64(C)
    assert torch.autograd.gradcheck(
        lambda x, w, b: P.lightweight_conv(x, w, 2, weight_softmax=True, bias=b), (x, w, b))
    q, wl, lb = f64(B, T, C), f64(C, H * K), f64(H * K)
    assert torch.autograd.gradcheck(
        lambda x, q, wl, lb: P.dynamic_conv(x, q, wl, H, K, 1, linear_bias=lb), (x, q, wl, lb))
    xb = torch.from_numpy(rng.randn(B, T, C).astype(np.float32)).bfloat16()
    wb = torch.from_numpy(rng.randn(H, K).astype(np.float32))
    y = P.lightweight_conv(xb, wb, 1)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               P.lightweight_conv(xb.float(), wb, 1).bfloat16().float().numpy())
