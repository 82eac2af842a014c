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
from tests.torch_parity import jax_tiny_flagship


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


# B2 and B6, plain versions against the JAX package's Pallas kernels in
# interpret mode. f32 x: the sums run in another order on the two sides (and
# the TPU int4 kernel folds an offset of 8 into the product and subtracts
# 8 * rowsum(x) after), so the JAX int8 kernel test's tolerance is used
# (`tests/test_quant.py:44`).
QMM_TOL = dict(atol=2e-3, rtol=1e-2)


def _quant_case(m, k, n, seed):
    rng = np.random.RandomState(seed)
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    x = rng.randn(m, k).astype(np.float32)
    return w, x


@pytest.mark.parametrize("m,k,n", [(100, 256, 384), (45, 200, 130), (7, 96, 612)])
def test_quantized_matmul_plain_matches_jax(m, k, n):
    from omni_avsr_tpu.ops.quant import quantize_per_channel as jqpc
    from omni_avsr_tpu.ops.quant import quantized_linear_xla, quantized_matmul as jqmm
    from omni_avsr_tpu_torch.ops.quant import (
        arrange_for_card,
        quantize_per_channel,
        quantized_matmul,
    )

    w, x = _quant_case(m, k, n, seed=m + n)
    jq = jqpc(jnp.asarray(w))
    ref = np.asarray(jqmm(jnp.asarray(x), jq, block_m=64, block_n=128, block_k=128,
                          interpret=True))
    xla = np.asarray(quantized_linear_xla(jnp.asarray(x), jq))
    before = quantized_matmul.launches
    leaf = quantize_per_channel(torch.from_numpy(w))
    ours = quantized_matmul(torch.from_numpy(x), leaf)
    assert quantized_matmul.launches == before  # CPU tensors: the plain version
    card = arrange_for_card(leaf)  # the serving layout
    assert "w" not in card and card["wc"].shape == (-(-n // 128) * 2, -(-k // 64), 4096)
    torch.testing.assert_close(quantized_matmul(torch.from_numpy(x), card), ours,
                               atol=0, rtol=0)
    assert ours.shape == (m, n) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, **QMM_TOL)
    np.testing.assert_allclose(ours.numpy(), xla, **QMM_TOL)


@pytest.mark.parametrize("block_n,k,n", [(256, 64, 512), (256, 96, 612), (512, 32, 1100)])
def test_pack_int4_bit_identical(block_n, k, n):
    from omni_avsr_tpu.ops.quant import pack_int4 as jpack, quantize_per_channel as jqpc
    from omni_avsr_tpu_torch.ops.quant import pack_int4, quantize_per_channel, unpack_int4

    w = np.random.RandomState(k).randn(k, n).astype(np.float32)
    jq4 = jpack(jqpc(jnp.asarray(w), bits=4), block_n=block_n)
    q = quantize_per_channel(torch.from_numpy(w), bits=4)
    q4 = pack_int4(q, block_n=block_n)
    assert q4["w4"].dtype == torch.int8 and q4["w4"].shape == jq4["w4"].shape
    np.testing.assert_array_equal(q4["w4"].numpy(), np.asarray(jq4["w4"]))
    np.testing.assert_array_equal(q4["s"].numpy(), np.asarray(jq4["s"]))
    np.testing.assert_array_equal(unpack_int4(q4["w4"], n).numpy(), q["w"].numpy())


@pytest.mark.parametrize("m,k,n,out_f32", [(1, 128, 256, False), (5, 96, 612, True),
                                           (45, 256, 300, True)])
def test_quantized_matmul4_plain_matches_jax(m, k, n, out_f32):
    from omni_avsr_tpu.ops.quant import pack_int4 as jpack, quantize_per_channel as jqpc
    from omni_avsr_tpu.ops.quant import quantized_matmul4 as jqmm4
    from omni_avsr_tpu_torch.ops.quant import pack_int4, quantize_per_channel, quantized_matmul4

    w, x = _quant_case(m, k, n, seed=k + n)
    out_dtype = jnp.float32 if out_f32 else None
    ref = np.asarray(jqmm4(jnp.asarray(x), jpack(jqpc(jnp.asarray(w), bits=4), block_n=256),
                           block_m=8, block_k=64, interpret=True, out_dtype=out_dtype))
    q4 = pack_int4(quantize_per_channel(torch.from_numpy(w), bits=4), block_n=256)
    before = quantized_matmul4.launches
    ours = quantized_matmul4(torch.from_numpy(x), q4,
                             out_dtype=torch.float32 if out_f32 else None)
    assert quantized_matmul4.launches == before
    assert ours.shape == (m, n)
    np.testing.assert_allclose(ours.numpy(), ref, **QMM_TOL)


def test_quantize_for_decode_int4_bit_identical():
    """int4-RTN codes on the LLM, q|k|v and gate|up fused, then packed two
    per byte; the towers int8, all as in the JAX package."""
    from omni_avsr_tpu.ops.quant import quantize_for_decode as jq
    from omni_avsr_tpu_torch.ops.quant import quantize_for_decode

    model = flagship(tiny=True, dtype=torch.float32)
    tree = _numpy_tree(init_params(model.cfg, torch.Generator().manual_seed(5), "cpu",
                                   frozen_dtype=torch.float32))
    ref = dict(_flat(jax.device_get(jq(jax.tree_util.tree_map(jnp.asarray, tree), "int4"))))
    ours = dict(_flat(quantize_for_decode(params_from_numpy(tree, "cpu"), "int4")))
    assert ours.keys() == ref.keys()
    for path, r in ref.items():
        o = ours[path].numpy()
        assert o.dtype == r.dtype and o.shape == r.shape, path
        np.testing.assert_array_equal(o, r, err_msg=path)
    w4 = [p for p in ours if p.endswith(".w4")]
    assert sorted(w4) == ["llm.layers.attn.o.w4", "llm.layers.attn.qkv.w4",
                          "llm.layers.mlp.down.w4", "llm.layers.mlp.gateup.w4", "llm.lm_head.w4"]
    assert sum(v.dtype == torch.int8 and not p.endswith(".w4") for p, v in ours.items()) == 12


def test_int4_linear_and_lm_head():
    """A packed leaf through `linear` (bias added after) and through
    `lm_head` (f32 logits), against the JAX functions on the same leaf."""
    from omni_avsr_tpu.models.common import linear as jlinear
    from omni_avsr_tpu.models.llm import lm_head as jlm_head
    from omni_avsr_tpu.ops.quant import pack_int4 as jpack, quantize_per_channel as jqpc
    from omni_avsr_tpu_torch.models.common import linear
    from omni_avsr_tpu_torch.models.llm import lm_head

    rng = np.random.RandomState(9)
    w = (rng.randn(128, 700) * 0.05).astype(np.float32)
    b = rng.randn(700).astype(np.float32)
    x = rng.randn(3, 5, 128).astype(np.float32)
    jleaf = jpack(jqpc(jnp.asarray(w), bits=4))
    leaf = params_from_numpy(jax.device_get(jleaf), "cpu")
    ref = np.asarray(jlinear(jnp.asarray(x), {**jleaf, "b": jnp.asarray(b)}))
    ours = linear(torch.from_numpy(x), {**leaf, "b": torch.from_numpy(b)})
    np.testing.assert_allclose(ours.numpy(), ref, **QMM_TOL)

    cfg = flagship(tiny=True).cfg.llm
    jcfg = jax_tiny_flagship().cfg.llm
    scale = np.ones(128, np.float32)
    jp = {"final_norm": {"scale": jnp.asarray(scale)}, "lm_head": jleaf}
    tp = {"final_norm": {"scale": torch.from_numpy(scale)}, "lm_head": leaf}
    ref = np.asarray(jlm_head(jp, jcfg, jnp.asarray(x)))
    ours = lm_head(tp, cfg, torch.from_numpy(x))
    assert ours.dtype == torch.float32 and ours.shape == (3, 5, 700)
    np.testing.assert_allclose(ours.numpy(), ref, **QMM_TOL)


@pytest.mark.parametrize("vocab", [256, 261])
def test_tied_lm_head_codes_are_contiguous(vocab):
    """The tied lm_head is quantised from the embedding's transpose; its
    codes must be contiguous (B2 streams them in long runs) also at a width
    that needs no padding, like Llama-3's 128256, and in the card layout."""
    from omni_avsr_tpu_torch.ops.quant import (
        arrange_for_card,
        card_int8_codes,
        quantize_llm_params,
        quantize_per_channel,
    )

    embed = torch.randn(vocab, 32, generator=torch.Generator().manual_seed(vocab))
    llm = {"embed": {"w": embed}, "layers": {"attn": {}, "mlp": {}}}
    head = quantize_llm_params(llm)["lm_head"]
    want = quantize_per_channel(embed.t().contiguous())["w"]
    assert head["w"].is_contiguous() and head["s"].shape == (vocab,)
    np.testing.assert_array_equal(head["w"].numpy(), want.numpy())
    card = arrange_for_card({"lm_head": head})["lm_head"]
    assert card["wc"].is_contiguous()
    np.testing.assert_array_equal(card_int8_codes(card["wc"], 32, vocab).numpy(), want.numpy())


# B2's card layout: the JAX codes, arranged in the order in which the
# kernel's threads load them as tensor-core fragments, and back.
@pytest.mark.parametrize("shape", [(16, 37), (64, 128), (48, 261), (2048, 128261 % 1024),
                                   (3, 32, 200), (2, 80, 37)])
def test_card_layout_round_trip(shape):
    from omni_avsr_tpu_torch.models.common import layer_slice
    from omni_avsr_tpu_torch.ops.quant import arrange_for_card, card_int8_codes

    g = torch.Generator().manual_seed(sum(shape))
    w = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
    *lead, k, n = shape
    leaf = {"w": w, "s": torch.rand(*lead, n, generator=g), "b": torch.zeros(*lead, n)}
    card = arrange_for_card({"layers": {"fc": leaf}})["layers"]["fc"]
    assert sorted(card) == ["b", "s", "wc"] and card["s"] is leaf["s"]
    kp, np_ = -(-k // 64) * 64, -(-n // 128) * 128
    assert card["wc"].shape == (*lead, np_ // 64, kp // 64, 4096)
    assert card["wc"].dtype == torch.int8 and card["wc"].is_contiguous()
    assert torch.equal(card_int8_codes(card["wc"], k, n), w)
    # padding is zero codes: the arranged bytes hold each code once
    assert int((card["wc"] != 0).sum()) == int((w != 0).sum())
    if lead:  # a stacked leaf: layer i of the arranged tree arranges layer i
        one = layer_slice({"fc": card}, 1)["fc"]
        assert torch.equal(card_int8_codes(one["wc"], k, n), w[1])


def test_card_layout_fragment_order():
    """Byte b of lane l in the 512 bytes of a 16-column x 32-k tile is the
    code that the lane's mma A fragment holds there: column g + 8 * (r & 1),
    k 16 * (b // 8) + 2 * t + e + 8 * (r >> 1), with g = l // 4, t = l % 4,
    r = (b % 8) // 2, e = b % 2 (`csrc/quant_matmul.cu`)."""
    from omni_avsr_tpu_torch.ops.quant import card_int8_layout

    k, n = 128, 256
    w = torch.randint(-127, 128, (k, n), generator=torch.Generator().manual_seed(0),
                      dtype=torch.int8)
    flat = card_int8_layout(w).reshape(-1)
    ks = k // 64
    idx = torch.arange(flat.numel())
    chunk, rem = idx // 4096, idx % 4096
    tile, ks_i = chunk // ks, chunk % ks
    wq, half, lane, byte = rem // 1024, (rem // 512) % 2, (rem // 16) % 32, rem % 16
    g, t, r, e = lane // 4, lane % 4, (byte % 8) // 2, byte % 2
    col = tile * 64 + wq * 16 + g + 8 * (r & 1)
    row = ks_i * 64 + half * 32 + (byte // 8) * 16 + 2 * t + e + 8 * (r >> 1)
    assert torch.equal(flat, w[row, col])


@pytest.mark.parametrize("m", [1, 3, 45, 130])
def test_card_layout_plain_matches_jax(m):
    """The plain version on a card-layout leaf equals the JAX Pallas kernel
    (interpret mode) at tiny sizes, in f32 and with bf16 x."""
    from omni_avsr_tpu.ops.quant import quantize_per_channel as jqpc
    from omni_avsr_tpu.ops.quant import quantized_matmul as jqmm
    from omni_avsr_tpu_torch.ops.quant import (
        arrange_for_card,
        quantize_per_channel,
        quantized_matmul,
    )

    k, n = 96, 200
    w, x = _quant_case(m, k, n, seed=m)
    ref = np.asarray(jqmm(jnp.asarray(x), jqpc(jnp.asarray(w)), block_m=8, block_n=128,
                          block_k=32, interpret=True))
    card = arrange_for_card(quantize_per_channel(torch.from_numpy(w)))
    ours = quantized_matmul(torch.from_numpy(x), card)
    assert ours.shape == (m, n)
    np.testing.assert_allclose(ours.numpy(), ref, **QMM_TOL)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref_b = np.asarray(jqmm(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                            jqpc(jnp.asarray(w)), block_m=8, block_n=128, block_k=32,
                            interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(quantized_matmul(xb, card).float().numpy(), ref_b,
                               atol=2e-2, rtol=2e-2)


# B2's launch plans at every shape of the serving paths: the decode
# matrices (M 45, and 3 for greedy decoding), the lm_head, the prefills of
# the bucketed and 30 s windows and the towers' matrices.
@pytest.mark.parametrize("M,K,N,plan", [
    (45, 2048, 3072, (48, 2, 4, 6, 132)), (45, 2048, 2048, (48, 1, 8, 3, 132)),
    (45, 2048, 16384, (48, 8, 2, 7, 132)), (45, 8192, 2048, (48, 1, 8, 3, 132)),
    (45, 2048, 128261, (48, 8, 2, 7, 132)), (45, 2048, 128256, (48, 8, 2, 7, 132)),
    (3, 2048, 3072, (16, 2, 4, 8, 132)), (3, 2048, 128261, (16, 8, 2, 8, 132)),
    (1, 1024, 1024, (16, 1, 8, 8, 132)), (64, 4096, 1024, (64, 1, 8, 2, 132)),
    (7, 48, 37, (16, 4, 1, 8, 132)), (1, 64, 16, (16, 4, 1, 8, 132)),
    (528, 2048, 3072, (128, 8, 1, 8, 120)), (528, 2048, 2048, (128, 8, 1, 8, 80)),
    (528, 2048, 16384, (128, 8, 1, 8, 640)), (528, 8192, 2048, (128, 8, 1, 8, 80)),
    (1200, 2048, 3072, (256, 8, 1, 5, 120)), (480, 1024, 1024, (64, 4, 2, 8, 132)),
    (480, 1024, 4096, (128, 8, 1, 8, 128)), (480, 4096, 1024, (64, 4, 4, 3, 132)),
    (975, 1024, 1024, (64, 8, 2, 6, 132)), (975, 1024, 4096, (256, 8, 1, 5, 128)),
    (975, 4096, 1024, (64, 8, 2, 6, 132)), (1152, 1024, 4096, (128, 8, 1, 8, 288)),
    (4500, 1024, 4096, (256, 8, 1, 5, 576)), (4500, 4096, 1024, (256, 8, 1, 5, 144)),
    (65, 1024, 4096, (64, 4, 2, 8, 132)),
])
def test_qmm8_plan(M, K, N, plan):
    from omni_avsr_tpu_torch.ops.quant import qmm_plan

    assert qmm_plan(M, N, K, 132, 8) == plan
    nt, cw, ks, stages, blocks = plan
    if nt <= 64:
        # a kernel instantiation of csrc/quant_matmul.cu, its split dividing K
        assert nt == (-(-M // 16) * 16 if M <= 64 else 64)
        assert (cw, ks) in {(1, 4), (1, 8), (2, 4), (2, 8), (4, 1), (4, 2), (4, 4), (8, 1), (8, 2)}
        assert -(-K // 64) % ks == 0 and blocks == 132
    else:
        assert nt in (128, 256) and (cw, ks) == (8, 1)
        assert blocks == -(-N // 128) * -(-M // nt)
        assert stages * (nt * 128 + 8192) >= nt * 132 * 4  # the epilogue's tile fits the ring
    # the ring and the k split's partial sums fit 227 KB of shared memory
    assert 1024 + stages * ks * (nt * 128 + cw * 1024) + 16 * stages \
        + (ks - 1) * cw * nt * 64 <= 232448


def test_cuda_route_requires_card_layout():
    """A leaf in the JAX layout is refused before any launch: the card
    never re-arranges weights per call."""
    from omni_avsr_tpu_torch.ops.quant import (
        arrange_for_card,
        quantize_per_channel,
        require_card_layout,
    )

    leaf = quantize_per_channel(torch.randn(32, 40))
    with pytest.raises(ValueError, match="card layout"):
        require_card_layout(leaf)
    assert require_card_layout(arrange_for_card(leaf)).shape == (2, 1, 4096)


def test_cuda_route_requires_int4_card_layout():
    """B6 refuses a packed leaf in the JAX layout (and an int8 card leaf)
    before any launch; the int4 card layout is what it reads."""
    from omni_avsr_tpu_torch.ops.quant import (
        arrange_for_card,
        pack_int4,
        quantize_per_channel,
        require_card_layout,
    )

    q = quantize_per_channel(torch.randn(32, 40), bits=4)
    with pytest.raises(ValueError, match="card layout"):
        require_card_layout(pack_int4(q), bits=4)
    with pytest.raises(ValueError, match="card layout"):
        require_card_layout(arrange_for_card(q), bits=4)
    assert require_card_layout(arrange_for_card(pack_int4(q)), bits=4).shape == (2, 1, 2048)


# B6's card layout: the packed codes, arranged in the order in which the
# kernel's threads load them as tensor-core fragments, and back.
@pytest.mark.parametrize("shape", [(16, 37), (64, 128), (48, 261), (64, 128261), (96, 1100),
                                   (3, 32, 200), (2, 80, 37)])
def test_int4_card_layout_round_trip(shape):
    from omni_avsr_tpu_torch.models.common import layer_slice
    from omni_avsr_tpu_torch.ops.quant import (
        arrange_for_card,
        card_int4_codes,
        pack_int4,
        unpack_int4,
    )

    g = torch.Generator().manual_seed(sum(shape))
    w = torch.randint(-8, 8, shape, generator=g, dtype=torch.int8)
    *lead, k, n = shape
    q4 = pack_int4({"w": w, "s": torch.rand(*lead, n, generator=g)})
    leaf = {**q4, "b": torch.zeros(*lead, n)}
    card = arrange_for_card({"layers": {"fc": leaf}})["layers"]["fc"]
    assert sorted(card) == ["b", "s", "w4c"] and card["s"] is leaf["s"]
    kp, np_ = -(-k // 64) * 64, -(-n // 128) * 128
    assert card["w4c"].shape == (*lead, np_ // 64, kp // 64, 2048)
    assert card["w4c"].dtype == torch.int8 and card["w4c"].is_contiguous()
    assert torch.equal(card_int4_codes(card["w4c"], k, n), unpack_int4(q4["w4"], n))
    assert torch.equal(card_int4_codes(card["w4c"], k, n), w)
    # padding is code 0 (nibble 8): the arranged nibbles hold each code once
    nib = card["w4c"].to(torch.int32) & 0xFF
    nonzero = int(((nib & 0xF) != 8).sum() + ((nib >> 4) != 8).sum())
    assert nonzero == int((w != 0).sum())
    if lead:  # a stacked leaf: layer i of the arranged tree arranges layer i
        one = layer_slice({"fc": card}, 1)["fc"]
        assert torch.equal(card_int4_codes(one["w4c"], k, n), w[1])


def test_int4_card_layout_fragment_order():
    """Word kk of lane l in the 512 bytes of a 16-column x 64-k tile holds
    the four A registers j of the lane's 16-deep step kk: nibble j (bits
    4j..4j+3) the code of column g + 8 * (j & 1), k 16 kk + 8 (j >> 1) +
    2 t, nibble j + 4 the code at k + 1, each as code + 8, with g = l // 4,
    t = l % 4 (`csrc/quant_matmul.cu::int4x8_to_bf16`)."""
    from omni_avsr_tpu_torch.ops.quant import card_int4_layout

    k, n = 128, 256
    w = torch.randint(-8, 8, (k, n), generator=torch.Generator().manual_seed(0),
                      dtype=torch.int8)
    flat = card_int4_layout(w).reshape(-1).to(torch.int64) & 0xFF
    # nibble i of the flat layout: the low nibble of byte i // 2 first
    nib = torch.stack([flat & 0xF, flat >> 4], dim=-1).reshape(-1) - 8
    ks = k // 64
    idx = torch.arange(nib.numel())
    chunk, rem = idx // 4096, idx % 4096
    tile, ks_i = chunk // ks, chunk % ks
    wq, lane, kk, pos = rem // 1024, (rem // 32) % 32, (rem // 8) % 4, rem % 8
    g, t, j, e = lane // 4, lane % 4, pos % 4, pos // 4
    col = tile * 64 + wq * 16 + g + 8 * (j & 1)
    row = ks_i * 64 + 16 * kk + 8 * (j >> 1) + 2 * t + e
    assert torch.equal(nib, w[row, col].to(torch.int64))


@pytest.mark.parametrize("m,k,n,out_f32", [(1, 128, 256, False), (5, 96, 612, True),
                                           (45, 256, 300, True), (130, 64, 130, False)])
def test_int4_card_layout_plain_matches_jax(m, k, n, out_f32):
    """The plain version on an int4 card-layout leaf equals the JAX Pallas
    kernel (interpret mode) at tiny sizes, in f32."""
    from omni_avsr_tpu.ops.quant import pack_int4 as jpack, quantize_per_channel as jqpc
    from omni_avsr_tpu.ops.quant import quantized_matmul4 as jqmm4
    from omni_avsr_tpu_torch.ops.quant import (
        arrange_for_card,
        pack_int4,
        quantize_per_channel,
        quantized_matmul4,
    )

    w, x = _quant_case(m, k, n, seed=k + n + 1)
    out_dtype = jnp.float32 if out_f32 else None
    ref = np.asarray(jqmm4(jnp.asarray(x), jpack(jqpc(jnp.asarray(w), bits=4), block_n=256),
                           block_m=8, block_k=64, interpret=True, out_dtype=out_dtype))
    card = arrange_for_card(pack_int4(quantize_per_channel(torch.from_numpy(w), bits=4)))
    ours = quantized_matmul4(torch.from_numpy(x), card,
                             out_dtype=torch.float32 if out_f32 else None)
    assert ours.shape == (m, n)
    np.testing.assert_allclose(ours.numpy(), ref, **QMM_TOL)


# B6's launch plans at every shape of configuration (c): the decode
# matrices at M 45, the prefill's at M 528 (3 x 176) and its lm_head at M 3
@pytest.mark.parametrize("M,K,N,plan", [
    (45, 2048, 3072, (48, 2, 4, 7, 132)), (45, 2048, 2048, (48, 1, 8, 3, 132)),
    (45, 2048, 16384, (48, 8, 2, 8, 132)), (45, 8192, 2048, (48, 1, 8, 3, 132)),
    (45, 2048, 128261, (48, 8, 2, 8, 132)),
    (528, 2048, 3072, (128, 8, 1, 8, 120)), (528, 2048, 2048, (128, 8, 1, 8, 80)),
    (528, 2048, 16384, (128, 8, 1, 8, 640)), (528, 8192, 2048, (128, 8, 1, 8, 80)),
    (3, 2048, 128261, (16, 8, 2, 8, 132)),
])
def test_qmm_plan_int4(M, K, N, plan):
    from omni_avsr_tpu_torch.ops.quant import qmm_plan

    assert qmm_plan(M, N, K, 132, 4) == plan
    nt, cw, ks, stages, blocks = plan
    # an int4 step carries half the code bytes: a ring at least as deep as int8's
    assert stages >= qmm_plan(M, N, K, 132, 8)[3]
    if nt <= 64:
        assert nt == -(-M // 16) * 16 and -(-K // 64) % ks == 0 and blocks == 132
        assert (cw, ks) in {(1, 4), (1, 8), (2, 4), (2, 8), (4, 1), (4, 2), (4, 4), (8, 1), (8, 2)}
    else:
        assert nt in (128, 256) and (cw, ks) == (8, 1)
        assert blocks == -(-N // 128) * -(-M // nt)
        assert stages * (nt * 128 + 4096) >= nt * 132 * 4  # the epilogue's tile fits the ring
    assert 1024 + stages * ks * (nt * 128 + cw * 512) + 16 * stages \
        + (ks - 1) * cw * nt * 64 <= 232448


def test_arrange_for_card_on_an_int4_serving_tree():
    """The serving tree of configuration (c) laid out for the card: the
    LLM's packed leaves become B6's card layout, the towers' int8 leaves
    B2's, and every other leaf (norms, biases, LoRA, convs, embeddings,
    scales) is the same tensor as before."""
    from omni_avsr_tpu_torch.ops.quant import (
        arrange_for_card,
        card_int4_codes,
        card_int8_codes,
        quantize_for_decode,
        unpack_int4,
    )

    model = flagship(tiny=True, dtype=torch.float32)
    tree = quantize_for_decode(init_params(model.cfg, torch.Generator().manual_seed(6), "cpu",
                                           frozen_dtype=torch.float32), "int4")
    card = arrange_for_card(tree)
    before, after = dict(_flat(tree)), dict(_flat(card))
    w4 = sorted(p[:-3] for p in before if p.endswith(".w4"))
    w8 = sorted(p[:-2] for p, v in before.items() if p.endswith(".w") and v.dtype == torch.int8)
    assert w4 == ["llm.layers.attn.o", "llm.layers.attn.qkv", "llm.layers.mlp.down",
                  "llm.layers.mlp.gateup", "llm.lm_head"]
    assert len(w8) == 12 and all(p.split(".")[0] in ("whisper", "avhubert") for p in w8)
    assert sorted(p[:-4] for p in after if p.endswith(".w4c")) == w4
    assert sorted(p[:-3] for p in after if p.endswith(".wc")) == w8
    assert not any(p.endswith((".w4",)) for p in after)
    changed = {f"{p}.w4" for p in w4} | {f"{p}.w" for p in w8}
    assert set(before) - changed == set(after) - {f"{p}.w4c" for p in w4} - {f"{p}.wc" for p in w8}
    for path in set(before) - changed:
        assert after[path] is before[path], path
    for p in w4:
        k = before[f"{p}.w4"].shape[-3]
        n = before[f"{p}.s"].shape[-1]
        assert torch.equal(card_int4_codes(after[f"{p}.w4c"], k, n),
                           unpack_int4(before[f"{p}.w4"], n)), p
    for p in w8:
        k, n = before[f"{p}.w"].shape[-2:]
        assert torch.equal(card_int8_codes(after[f"{p}.wc"], k, n), before[f"{p}.w"]), p
