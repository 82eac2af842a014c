"""B1, beam-decode attention on the ancestor cache: the port's plain version
(`omni_avsr_tpu_torch/ops/beam_attention.py`) against the JAX package's
Pallas kernel in interpret mode and against its XLA reorder route
(`_merged_beam_attention` on the physically reordered cache), in f32 at
the JAX test's own tolerance (atol = rtol = 2e-5,
tests/test_beam_attention.py). The CUDA kernel itself runs only on the
card: tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omni_avsr_tpu.config import LLMConfig
from omni_avsr_tpu.models.llm import NEG_INF, _merged_beam_attention
from omni_avsr_tpu.ops.beam_attention import beam_decode_attention as jax_beam_attention
from omni_avsr_tpu_torch.ops.beam_attention import (
    beam_decode_attention,
    beam_decode_attention_plain,
)

TOL = dict(rtol=2e-5, atol=2e-5)


def _case(B, K, Hq, Hkv, D, P, N, seed=0):
    rng = np.random.RandomState(seed)
    BK = B * K
    f = lambda *s: rng.randn(*s).astype(np.float32)
    prefix_mask = rng.rand(B, P) < 0.7
    prefix_mask[:, 0] = True
    return dict(
        q=f(BK, 1, Hq, D), pk=f(B, Hkv, P, D), pv=f(B, Hkv, P, D),
        gk=f(B, Hkv, K, N, D), gv=f(B, Hkv, K, N, D), k_cur=f(BK, Hkv, D), v_cur=f(BK, Hkv, D),
        prefix_bias=np.where(prefix_mask, 0.0, NEG_INF).astype(np.float32),
        anc=rng.randint(0, K, size=(B, K, N)).astype(np.int32),
    ), prefix_mask


def _port(c, step, K):
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    return beam_decode_attention_plain(**t, step=step, num_beams=K).numpy()


def _xla_reorder_route(c, prefix_mask, step, K, Hq, Hkv, D):
    """The reorder route on reordered[b, h, k, n] = gk[b, h, anc[b, k, n], n]."""
    gk, anc = c["gk"], c["anc"]
    B, _, _, N, _ = gk.shape
    b_idx = np.arange(B)[:, None, None]
    n_idx = np.arange(N)[None, None, :]

    def gather(x):
        g = x.transpose(0, 2, 3, 1, 4)[b_idx, anc, n_idx]  # (B, K, N, Hkv, D)
        return jnp.asarray(g.transpose(0, 1, 3, 2, 4).reshape(B * K, Hkv, N, D))

    cfg = LLMConfig(num_heads=Hq, num_kv_heads=Hkv, head_dim=D)
    return np.asarray(_merged_beam_attention(
        cfg, jnp.asarray(c["q"]), jnp.asarray(c["pk"]), jnp.asarray(c["pv"]),
        gather(c["gk"]), gather(c["gv"]), jnp.asarray(c["k_cur"]), jnp.asarray(c["v_cur"]),
        jnp.asarray(prefix_mask), jnp.arange(N) < step, K))


@functools.lru_cache(maxsize=None)
def _jax_kernel(K):
    """The interpret-mode Pallas kernel, jitted with a traced step (as in
    the decode loop), so each shape compiles once for all its steps."""
    return jax.jit(lambda *a: jax_beam_attention(*a, K, interpret=True))


# (B, K, G, Hkv, D, P, N) x step in {0, mid, N-1}: K from 1 (greedy) to 15
# (serving), GQA groups 1-4, batch 1-3, head dims 16 and 64
SHAPES = [(1, 15, 4, 2, 16, 48, 32), (2, 3, 2, 4, 64, 16, 8), (3, 1, 1, 4, 16, 24, 8)]
CASES = [(*s, step) for s in SHAPES for step in (0, s[-1] // 2 + 1, s[-1] - 1)]


@pytest.mark.parametrize("B,K,G,Hkv,D,P,N,step", CASES)
def test_plain_matches_pallas_kernel_and_reorder_route(B, K, G, Hkv, D, P, N, step):
    Hq = G * Hkv
    c, prefix_mask = _case(B, K, Hq, Hkv, D, P, N, seed=step + 10 * K)
    ours = _port(c, step, K)
    kern = np.asarray(_jax_kernel(K)(
        *(jnp.asarray(c[k]) for k in ("q", "pk", "pv", "gk", "gv", "k_cur", "v_cur",
                                      "prefix_bias", "anc")),
        jnp.int32(step)))
    np.testing.assert_allclose(ours, kern, **TOL)
    ref = _xla_reorder_route(c, prefix_mask, step, K, Hq, Hkv, D)
    np.testing.assert_allclose(ours, ref, **TOL)


def test_wrapper_takes_plain_version_on_cpu():
    """A CPU tensor goes to the plain version and launches nothing."""
    c, _ = _case(1, 3, 8, 4, 16, 16, 8)
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    before = beam_decode_attention.launches
    out = beam_decode_attention(**t, step=5, num_beams=3)
    assert beam_decode_attention.launches == before
    np.testing.assert_array_equal(out.numpy(), _port(c, 5, 3))


def test_bf16_plain_follows_the_kernel_casts():
    """In bf16 the plain version casts probabilities to the value dtype
    before the f32-accumulated value contraction, as the TPU kernel does;
    it stays within bf16 rounding of the f32 result."""
    c, _ = _case(1, 15, 32, 8, 64, 176, 32)
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    ref = beam_decode_attention_plain(**t, step=17, num_beams=15)
    tb = {k: (v.to(torch.bfloat16) if k not in ("prefix_bias", "anc") else v) for k, v in t.items()}
    out = beam_decode_attention_plain(**tb, step=17, num_beams=15)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=5e-2, rtol=5e-2)


# The kernel's schedule: the key list [prefix | generated | current] in
# 64-key tiles, split into contiguous runs whose partial softmaxes are
# merged (`beam_decode_attention_split`), held to the plain version in f32
# at 1e-5 (only the order of the sums differs). Cases: (B, K, G, Hkv, D, P,
# N, step, masked prefix range): serving-like K 15 at a middle step; K 1
# at step 0 (the current token is the only generated key); step N; and a
# prefix whose keys 64..127 are all masked, so that with 3 splits the
# middle run holds only masked keys.
SPLIT_CASES = [
    (2, 15, 4, 2, 16, 176, 32, 17, None),
    (1, 1, 4, 2, 16, 130, 8, 0, None),
    (1, 5, 2, 2, 16, 40, 8, 8, None),
    (1, 3, 2, 2, 16, 128, 8, 0, (64, 128)),
]


@pytest.mark.parametrize("case", SPLIT_CASES)
@pytest.mark.parametrize("splits", [1, 2, 3, "planned"])
def test_split_schedule_matches_plain(case, splits):
    from omni_avsr_tpu_torch.ops.beam_attention import beam_decode_attention_split, plan_splits

    B, K, G, Hkv, D, P, N, step, masked = case
    c, _ = _case(B, K, G * Hkv, Hkv, D, P, N, seed=7 + step)
    if masked is not None:
        c["prefix_bias"][:, masked[0]:masked[1]] = NEG_INF
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    if splits == "planned":
        splits = plan_splits(B, Hkv, K * G, P, K, step, sms=132)
    ref = beam_decode_attention_plain(**t, step=step, num_beams=K)
    out = beam_decode_attention_split(**t, step=step, num_beams=K, splits=splits)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_split_schedule_masked_run_is_all_masked():
    """The masked case above really gives one run nothing but masked keys:
    with 3 splits of 3 tiles, run 1 is keys 64..127, the masked prefix."""
    from omni_avsr_tpu_torch.ops.beam_attention import KEY_TILE

    B, K, G, Hkv, D, P, N, step, masked = SPLIT_CASES[3]
    T = P + K * step + K
    n = -(-T // KEY_TILE)
    assert n == 3 and (1 * n // 3 * KEY_TILE, 2 * n // 3 * KEY_TILE) == masked


# The split counts at the shapes chip_smoke.py times and checks (B, K, P,
# step at Hq 32 / Hkv 8, 132 SMs): as many splits as 64-key tiles, up to 8,
# fewer once B * Hkv * chunks alone puts two blocks on every SM.
@pytest.mark.parametrize("B,K,P,step,splits", [
    (3, 15, 176, 17, 7),   # serving, timed: 176 + 255 + 15 keys = 7 tiles
    (3, 15, 400, 17, 8),   # (a)'s prefix, timed: 11 tiles, capped at 8
    (3, 1, 176, 17, 4),    # greedy, timed: 194 keys = 4 tiles
    (1, 15, 176, 0, 3),    # step 0: 191 keys
    (4, 15, 176, 31, 8),   # step 31: 656 keys
    (1, 1, 176, 31, 4),    # B 1, K 1: 8 blocks alone, the widest split of its tiles
    (40, 15, 176, 17, 1),  # 320 units of 64 rows already fill the card twice
])
def test_plan_splits(B, K, P, step, splits):
    from omni_avsr_tpu_torch.ops.beam_attention import KEY_TILE, MAX_SPLITS, plan_splits

    got = plan_splits(B, 8, K * 4, P, K, step, sms=132)
    assert got == splits
    tiles = -(-(P + K * step + K) // KEY_TILE)
    assert 1 <= got <= min(MAX_SPLITS, tiles)  # every block of a cluster has a tile
