"""The port's debug helpers (`omni_avsr_tpu_torch/utils/profiling.py`)
against the JAX package's (`omni_avsr_tpu/utils/profiling.py:59-114`):

  - `count_nonfinite` equals JAX's on trees with NaN, Inf and integer
    leaves, as an int32 tensor;
  - `checkify_step` raises exactly where `checkify.float_checks` raises on
    the same small step (a log of 0 - 0, a 0/0, a 1/0, a NaN fed in, the
    square root of a negative, inf - inf, a NaN kept by a maximum, the
    gradient of a square root at 0, clean steps), naming the op, and
    returns the same outputs where it does not;
  - `chain_iteration` leaves the batch bit-equal in bf16 and f32 at
    acc = 1, as JAX's does, and keeps the other keys.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

X = np.array([0.5, -1.5, 2.0, 0.0], np.float32)
NAN_X = np.array([0.5, np.nan, 2.0, 1.0], np.float32)
W = np.array([[0.1, -0.2], [0.3, 0.4], [-0.5, 0.6], [0.7, 0.8]], np.float32)

# (name, input, the JAX step, the torch step)
STEPS = [
    ("clean", X, lambda x: jnp.mean((x @ W) ** 2), lambda x: ((x @ torch.from_numpy(W)) ** 2).mean()),
    ("clean softmax", X, lambda x: jax.nn.log_softmax(x * 3.0), lambda x: torch.log_softmax(x * 3.0, 0)),
    ("log of 0 - 0", X, lambda x: jnp.log(x - x), lambda x: torch.log(x - x)),
    ("sum of log of 0 - 0", X, lambda x: jnp.sum(jnp.log(x - x)), lambda x: torch.log(x - x).sum()),
    ("0 / 0", X, lambda x: (x - x) / (x - x), lambda x: (x - x) / (x - x)),
    ("1 / 0", X, lambda x: 1.0 / (x - x), lambda x: 1.0 / (x - x)),
    ("nan fed in", NAN_X, lambda x: jnp.sum(x * 2.0), lambda x: (x * 2.0).sum()),
    ("sqrt of a negative", X, lambda x: jnp.sqrt(-x), lambda x: torch.sqrt(-x)),
    ("inf - inf", X, lambda x: jnp.exp(x * 1e4) - jnp.exp(x * 1e4),
     lambda x: torch.exp(x * 1e4) - torch.exp(x * 1e4)),
    ("nan kept by a maximum", NAN_X, lambda x: jnp.maximum(x, 0.0),
     lambda x: torch.maximum(x, torch.zeros(()))),
    ("grad of sqrt at 0", X, lambda x: jax.grad(lambda v: jnp.sum(jnp.sqrt(v * v)))(x),
     lambda x: torch.autograd.grad(torch.sqrt((x * x)).sum(), x)[0]),
    ("grad, clean", X, lambda x: jax.grad(lambda v: jnp.sum(jnp.tanh(v) ** 2))(x),
     lambda x: torch.autograd.grad((torch.tanh(x) ** 2).sum(), x)[0]),
]


@pytest.mark.parametrize("name, x, jfn, tfn", STEPS, ids=[s[0] for s in STEPS])
def test_checkify_step_raises_where_jax_does(name, x, jfn, tfn):
    from omni_avsr_tpu.utils.profiling import checkify_step as jax_checkify
    from omni_avsr_tpu_torch.utils.profiling import checkify_step

    try:
        want = np.asarray(jax_checkify(jfn)(jnp.asarray(x)))
        jax_raised = None
    except Exception as e:  # checkify's JaxRuntimeError
        want, jax_raised = None, e
    tx = torch.from_numpy(x.copy()).requires_grad_(name.startswith("grad"))
    if jax_raised is None:
        got = checkify_step(tfn)(tx)
        np.testing.assert_array_equal(got.detach().numpy(), tfn(tx).detach().numpy())
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6)
    else:
        with pytest.raises(FloatingPointError, match=r"(nan generated by|division by zero in) "
                                                     r"op: aten\."):
            checkify_step(tfn)(tx)
        # JAX names the cause the same way: a NaN or a division by zero
        assert ("nan generated by primitive" in str(jax_raised)
                or "division by zero" in str(jax_raised)), jax_raised


def test_count_nonfinite_matches_jax():
    from omni_avsr_tpu.utils.profiling import count_nonfinite as jax_count
    from omni_avsr_tpu_torch.utils.profiling import count_nonfinite

    rng = np.random.RandomState(0)
    a = rng.randn(5, 7).astype(np.float32)
    a[1, 2], a[3, 3], a[4, 0] = np.nan, np.inf, -np.inf
    b = rng.randn(11).astype(np.float32)
    b[[2, 9]] = np.nan
    ints = np.arange(6, dtype=np.int32)
    tree = {"a": a, "sub": {"b": b, "ids": ints}, "clean": rng.randn(3).astype(np.float32)}
    want = jax_count(jax.tree_util.tree_map(jnp.asarray, tree))
    port = {"a": torch.from_numpy(a), "sub": {"b": torch.from_numpy(b).bfloat16(),
                                              "ids": torch.from_numpy(ints)},
            "clean": torch.from_numpy(tree["clean"])}
    got = count_nonfinite(port)
    assert got.dtype == torch.int32 and got.shape == () and int(got) == int(want) == 5
    none = count_nonfinite({"ids": torch.from_numpy(ints)})
    assert none.dtype == torch.int32 and int(none) == 0 == int(jax_count({"ids": ints}))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chain_iteration_is_bit_neutral_at_one(dtype):
    from omni_avsr_tpu.utils.profiling import chain_iteration as jax_chain
    from omni_avsr_tpu_torch.utils.profiling import chain_iteration

    audio = (np.random.RandomState(1).randn(2, 640) * 0.1).astype(np.float32)
    jb = {"audio": jnp.asarray(audio, dtype), "video": jnp.ones(3)}
    jout = jax_chain(jb, jnp.ones((), jnp.float32))
    tdt = getattr(torch, dtype)
    tb = {"audio": torch.from_numpy(audio).to(tdt), "video": torch.ones(3)}
    out = chain_iteration(tb, torch.ones(()))
    assert out["audio"].dtype == tdt and out["video"] is tb["video"] and out is not tb
    assert torch.equal(out["audio"], tb["audio"])  # bit for bit at acc = 1
    np.testing.assert_array_equal(np.asarray(jout["audio"], np.float32),
                                  out["audio"].float().numpy())
    # the dependency is real: a large acc moves the input
    assert not torch.equal(chain_iteration(tb, 1e38)["audio"], tb["audio"])
