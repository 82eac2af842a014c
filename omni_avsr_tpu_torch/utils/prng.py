"""JAX's default PRNG in torch: `jax.random` under `jax.random.PRNGKey(seed)`
(threefry2x32), bit for bit, in its partitionable layout
(`jax_threefry_partitionable=True`, JAX's default since 0.5; the JAX
package runs 0.9.0). The JAX package draws its dropout and augmentation
from these streams under `OMNI_PRNG=threefry`; with them the port's train
step draws the same masks, crops and noise offsets as the JAX one.

A key is a (2,) int64 tensor on the CPU holding two uint32 words, as
`jax.random.PRNGKey` holds them; `split` returns (num, 2). Keys are
derived on the host (a few hundred integer operations each), and a draw
hashes its counters on the device it is asked for: the arithmetic is
exact integer arithmetic masked to 32 bits, so the CPU and the card give
the same bits. Only the 32-bit draws the JAX package makes are ported:
`random_bits`, `uniform` (f32), `bernoulli` and `randint` (int32).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

MASK = 0xFFFFFFFF
# draws of at most this many values on the CPU hash as Python ints: the same
# arithmetic without a torch op per round
_SMALL = 64

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(int(s) for s in shape)


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k1: int, k2: int, x1, x2):
    """The Threefry-2x32 hash of the counter pair (x1, x2) under the key
    words (k1, k2), 20 rounds (`jax/_src/prng.py:883`,
    `_threefry2x32_lowering`, unrolled). x1 and x2 are Python ints or int64
    tensors holding uint32 values; the result is of the same kind."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in rotations[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def _words(key: torch.Tensor) -> Tuple[int, int]:
    if tuple(key.shape) != (2,):
        raise ValueError(f"a threefry key is a (2,) tensor, got shape {tuple(key.shape)}")
    k1, k2 = (int(v) for v in key.tolist())
    return k1, k2


def _hash_iota(key: torch.Tensor, n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hash of the 64-bit counters 0..n-1 split into (high, low) words,
    `iota_2x32_shape` (`prng.py:1000`): both output words, (n,) int64."""
    k1, k2 = _words(key)
    device = torch.device(device)
    if n <= _SMALL and device.type == "cpu":
        pairs = [threefry2x32(k1, k2, i >> 32, i & MASK) for i in range(n)]
        return (torch.tensor([p[0] for p in pairs], dtype=torch.int64),
                torch.tensor([p[1] for p in pairs], dtype=torch.int64))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return threefry2x32(k1, k2, idx >> 32, idx & MASK)


def PRNGKey(seed: int) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` with 64-bit types off: the words (0,
    seed mod 2**32) (`prng.py:802`, `threefry_seed`)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)` -> (num, 2) keys: the hash of the
    counters 0..num-1 (`prng.py:1156`, `_threefry_split_foldlike`)."""
    b1, b2 = _hash_iota(key, num, "cpu")
    return torch.stack([b1, b2], dim=1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`: the hash of the counter pair (0,
    data) (`prng.py:1163-1169`)."""
    k1, k2 = _words(key)
    return torch.tensor(threefry2x32(k1, k2, 0, int(data) & MASK), dtype=torch.int64)


def random_bits(key: torch.Tensor, shape: Shape = (), device="cpu") -> torch.Tensor:
    """`jax.random.bits(key, shape)` (uint32): the two words of each
    element's counter hash xored (`prng.py:1184`,
    `_threefry_random_bits_partitionable`), as int64 on `device`."""
    shape = _shape(shape)
    n = 1
    for s in shape:
        n *= s
    b1, b2 = _hash_iota(key, n, device)
    return (b1 ^ b2).reshape(shape)


def uniform(key: torch.Tensor, shape: Shape = (), device="cpu", minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(key, shape)` in f32: 23 random mantissa bits
    under exponent 0, minus 1, scaled to [minval, maxval)
    (`jax/_src/random.py:435`, `_uniform`)."""
    bits = random_bits(key, shape, device)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def bernoulli(key: torch.Tensor, p: float, shape: Shape = (), device="cpu") -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)`: uniform < p in f32
    (`random.py:1075`, `_bernoulli`, mode "low")."""
    u = uniform(key, shape, device)
    return u < torch.tensor(p, dtype=torch.float32, device=u.device)


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int,
            device="cpu") -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval)` (int32): two 32-bit
    draws from the key's two halves folded into [minval, maxval) by
    uint32 remainders (`random.py:581`, `_randint`); the span is 1 when
    maxval <= minval."""
    lo32, hi32 = -(2**31), 2**31 - 1
    if not (lo32 <= minval <= hi32 and lo32 <= maxval <= hi32):
        raise ValueError(f"randint bounds [{minval}, {maxval}) outside int32")
    k1, k2 = split(key)
    higher = random_bits(k1, shape, device)
    lower = random_bits(k2, shape, device)
    span = (maxval - minval) & MASK if maxval > minval else 1
    multiplier = (((2**16 % span) ** 2) & MASK) % span  # uint32 products wrap
    offset = (((higher % span) * multiplier) & MASK) + lower % span
    offset = (offset & MASK) % span
    return (minval + offset).to(torch.int32)
