"""The port's threefry streams (`omni_avsr_tpu_torch/utils/prng.py`) against
`jax.random` under `jax.random.PRNGKey(seed)`, bit for bit: keys, splits
and fold-ins, and the 32-bit draws the JAX package makes (`random_bits`,
`uniform`, `bernoulli`, `randint`) at seeds 0, 1, 42 and 2**31 - 1, at
shapes (), (7,), (3, 5), (4, 320, 64) and an odd-sized (3, 7, 11).
The port implements JAX's partitionable threefry layout only; the first
test fails if an upgrade of JAX changes that default.
"""

import numpy as np
import pytest
import torch

import jax

from omni_avsr_tpu_torch.utils import prng

SEEDS = [0, 1, 42, 2**31 - 1]
SHAPES = [(), (7,), (3, 5), (4, 320, 64), (3, 7, 11)]


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """The draws are elementwise integer ops on small tensors: more threads
    only contend with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint32)


def test_jax_threefry_is_partitionable():
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy().astype(np.uint32), _u32(jk))
    for num in (1, 2, 3, 24, 100):  # 100: past the host path's 64 counters
        np.testing.assert_array_equal(prng.split(tk, num).numpy().astype(np.uint32),
                                      _u32(jax.random.split(jk, num)))
    for data in (0, 7, 2**31 - 1):
        np.testing.assert_array_equal(prng.fold_in(tk, data).numpy().astype(np.uint32),
                                      _u32(jax.random.fold_in(jk, data)))
    # a key of a key: the engine's chain of splits
    jk2, tk2 = jax.random.split(jax.random.split(jk)[1], 3)[2], prng.split(prng.split(tk)[1], 3)[2]
    np.testing.assert_array_equal(tk2.numpy().astype(np.uint32), _u32(jk2))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_draws_match_jax(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    bits = prng.random_bits(tk, shape)
    assert tuple(bits.shape) == shape
    np.testing.assert_array_equal(bits.numpy().astype(np.uint32),
                                  _u32(jax.random.bits(jk, shape)))
    u = prng.uniform(tk, shape)
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(u.numpy().view(np.uint32),
                                  np.asarray(jax.random.uniform(jk, shape)).view(np.uint32))
    for p in (0.9, 0.5):
        np.testing.assert_array_equal(prng.bernoulli(tk, p, shape).numpy(),
                                      np.asarray(jax.random.bernoulli(jk, p, shape)))


@pytest.mark.parametrize("bounds", [(0, 1), (0, 2**31 - 1), (3, 1000), (-5, 7), (7, 3)],
                         ids=["span1", "span2^31-1", "span997", "negative", "empty"])
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_matches_jax(seed, bounds):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    lo, hi = bounds
    # the fold into [lo, hi) is elementwise: the draws test holds the large shape
    for shape in ((), (3, 7, 11)):
        got = prng.randint(tk, shape, lo, hi)
        want = np.asarray(jax.random.randint(jk, shape, lo, hi))
        assert got.dtype == torch.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_host_and_tensor_paths_agree(monkeypatch):
    """Draws of up to 64 values on the CPU hash as Python ints; the same
    counters through the tensor path give the same bits."""
    key = prng.split(prng.PRNGKey(5), 3)[1]
    small = prng.random_bits(key, (8, 8))
    monkeypatch.setattr(prng, "_SMALL", 0)
    np.testing.assert_array_equal(prng.random_bits(key, (8, 8)).numpy(), small.numpy())
