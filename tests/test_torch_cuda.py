"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU with nvcc (marked `cuda`; they skip where
there is none) and import neither JAX nor the JAX package, so they run
on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q -m cuda
"""

import pytest
import torch

from omni_avsr_tpu_torch.ops.beam_attention import (
    beam_decode_attention,
    beam_decode_attention_plain,
)


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels build and run only on the card")
    return torch.device("cuda")


def _beam_case(B, K, Hq, Hkv, D, P, N, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=device).to(torch.bfloat16)

    prefix_mask = torch.rand(B, P, generator=g, device=device) < 0.8
    prefix_mask[:, 0] = True
    return dict(
        q=rn(B * K, 1, Hq, D), pk=rn(B, Hkv, P, D), pv=rn(B, Hkv, P, D),
        gk=rn(B, Hkv, K, N, D), gv=rn(B, Hkv, K, N, D),
        k_cur=rn(B * K, Hkv, D), v_cur=rn(B * K, Hkv, D),
        prefix_bias=torch.where(prefix_mask, 0.0, -1e30).float(),
        anc=torch.randint(0, K, (B, K, N), generator=g, device=device, dtype=torch.int32),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,Hq,Hkv,D,P,N,step", [
    (1, 15, 32, 8, 64, 176, 32, 0),    # serving shapes, first step
    (3, 15, 32, 8, 64, 176, 32, 17),
    (4, 15, 32, 8, 64, 176, 32, 31),   # last slot
    (2, 1, 8, 4, 128, 40, 8, 5),       # K 1, head dim 128, P not a multiple of 32
    (1, 5, 8, 8, 64, 16, 16, 16),      # MHA, step == N
    (3, 15, 32, 8, 64, 400, 32, 17),   # the 30 s window's prefix: 8 key splits
    (2, 15, 32, 8, 64, 130, 32, 9),    # P not a multiple of the 64-key tile
    (1, 1, 32, 8, 64, 176, 32, 31),    # B 1, K 1: 8 blocks, the widest split of 4 tiles
    (1, 15, 8, 8, 64, 176, 32, 0),     # G 1, step 0: only the current token generated
    (2, 4, 64, 8, 128, 96, 16, 16),    # G 8, head dim 128, step == N
    (1, 4, 256, 8, 64, 64, 8, 5),      # G 32: 128 query rows, two chunks of 64
    (1, 3, 80, 2, 64, 64, 8, 5),       # G 40: a chunk of 64 rows starts inside beam 1
    (2, 65, 32, 8, 64, 176, 32, 17),   # 65 beams: past one 64-bit mask word
    (1, 80, 8, 4, 128, 96, 16, 9),     # 80 beams, G 2, head dim 128
    (1, 128, 32, 8, 64, 176, 32, 31),  # 128 beams, the last slot
    (3, 15, 28, 4, 128, 176, 32, 17),  # Qwen2.5-7B: G 7, 105 rows a kv head, beams straddle 64
    (1, 15, 28, 4, 128, 176, 32, 31),  # G 7, the last slot
    (2, 15, 12, 4, 128, 96, 32, 5),    # G 3, head dim 128
    (3, 15, 12, 2, 128, 176, 32, 17),  # Qwen2.5-1.5B: G 6
])
def test_beam_attention_kernel_matches_plain(cuda_device, B, K, Hq, Hkv, D, P, N, step):
    """bf16 in and out; the kernel keeps the probabilities in f32 where the
    plain version rounds them to bf16, hence the bf16-level tolerance."""
    inp = _beam_case(B, K, Hq, Hkv, D, P, N, cuda_device, seed=step + 10 * B)
    before = beam_decode_attention.launches
    out = beam_decode_attention(**inp, step=step, num_beams=K)
    assert beam_decode_attention.launches == before + 1
    ref = beam_decode_attention_plain(**inp, step=step, num_beams=K)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_beam_attention_wrapper_rejects_bad_input(cuda_device):
    inp = _beam_case(1, 3, 8, 4, 64, 16, 8, cuda_device, seed=0)
    with pytest.raises(ValueError, match="dtype"):
        beam_decode_attention(**{**inp, "q": inp["q"].float()}, step=1, num_beams=3)
    with pytest.raises(ValueError, match="contiguous"):
        beam_decode_attention(**{**inp, "gk": inp["gk"].transpose(2, 3).contiguous().transpose(2, 3)},
                              step=1, num_beams=3)
    with pytest.raises(ValueError, match="step"):
        beam_decode_attention(**inp, step=9, num_beams=3)


@pytest.mark.cuda
def test_beam_attention_largest_beam_count(cuda_device):
    """At 32 generated slots the wrapper takes every K up to the shared
    memory's limit, `max_beams(32, 64)`, and refuses one more beam."""
    from omni_avsr_tpu_torch.ops.beam_attention import max_beams

    K = max_beams(32, 64)
    assert K > 256
    inp = _beam_case(1, K, 1, 1, 64, 16, 32, cuda_device, seed=K)
    out = beam_decode_attention(**inp, step=3, num_beams=K)
    ref = beam_decode_attention_plain(**inp, step=3, num_beams=K)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    past = _beam_case(1, K + 1, 1, 1, 64, 16, 32, cuda_device, seed=0)
    with pytest.raises(ValueError, match="shared memory"):
        beam_decode_attention(**past, step=3, num_beams=K + 1)


@pytest.mark.cuda
def test_transcriber_decodes_65_beams(cuda_device):
    """A served batch at 65 beams on the card: the tiny flagship with the
    LLM's heads at B1's head dim (64), int8, 8 new tokens; every decode
    step launches B1 once per layer."""
    import dataclasses

    import numpy as np

    from omni_avsr_tpu_torch.bridge import init_params
    from omni_avsr_tpu_torch.models.omni import OmniAVSR, flagship
    from omni_avsr_tpu_torch.serve import Transcriber

    tiny = flagship(tiny=True, whisper_input_mode="bucket")
    llm = dataclasses.replace(tiny.cfg.llm, num_heads=2, num_kv_heads=1, head_dim=64)
    model = OmniAVSR(dataclasses.replace(tiny.cfg, llm=llm), tiny.tok, dtype=tiny.dtype)
    params = init_params(model.cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    t = Transcriber(model, params, quantize="int8", device="cuda", max_new_tokens=8)
    rng = np.random.RandomState(0)
    items = [{"audio": (rng.randn(n * 640) * 0.1).astype("float32"),
              "video": rng.randint(0, 255, (n, 96, 96, 3)).astype("uint8")} for n in (40, 33)]
    before = beam_decode_attention.launches
    texts = t.transcribe_many(items, num_beams=65)
    torch.cuda.synchronize()
    assert len(texts) == 2 and all(isinstance(x, str) for x in texts)
    assert 1 <= t.last_decode_steps <= 8
    assert beam_decode_attention.launches - before == llm.num_layers * t.last_decode_steps


# B2 and B6: bf16 x, an f32 accumulator on both sides; the kernel sums in
# another order than the plain f32 product and rounds the result to bf16
# (or returns f32), hence a bf16-level tolerance on the bf16 outputs.
def _quant_inputs(M, K, N, device, seed, bits=8):
    from omni_avsr_tpu_torch.ops.quant import quantize_per_channel

    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn(K, N, generator=g, device=device) * 0.05
    x = torch.randn(M, K, generator=g, device=device).to(torch.bfloat16)
    return x, quantize_per_channel(w, bits)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,out_f32", [
    (45, 2048, 3072, False),    # decode q|k|v: token tile 48, 32-column groups
    (45, 2048, 2048, True),     # decode o: 16-column groups, K split 8 ways
    (45, 2048, 16384, False),   # decode gate|up: 128-column groups
    (45, 8192, 2048, False),    # decode down
    (45, 2048, 128261, True),   # the lm_head: odd N, f32 logits, blocks walk the groups
    (1, 1024, 1024, True),      # one token
    (3, 2048, 3072, False),     # greedy decoding, 3 requests
    (64, 4096, 1024, False),    # the largest decode tile
    (65, 1024, 4096, True),     # one row past it: two 64-token tiles
    (528, 2048, 2048, False),   # prefill (3 x 176): wgmma, 128-token tiles
    (480, 4096, 1024, False),   # AV-HuBERT fc2, bucketed window: mma.sync, 64-token tiles
    (975, 1024, 1024, True),    # Whisper q, bucketed window: 64-token tiles, 128 columns
    (975, 1024, 4096, False),   # Whisper fc1, bucketed window: ragged M
    (4500, 1024, 4096, False),  # Whisper fc1 at the 30 s window, 256-token tiles
    (4500, 4096, 1024, True),   # Whisper fc2
    (1, 64, 16, True),          # smallest
    (7, 48, 37, False),         # K not a multiple of 64, N of 16
    (45, 3584, 4608, False),    # Qwen2.5-7B decode q|k|v (the bias is added after)
    (45, 3584, 37888, False),   # Qwen2.5-7B decode gate|up
    (45, 18944, 3584, False),   # Qwen2.5-7B decode down: K 18944
    (45, 3584, 151650, True),   # Qwen2.5-7B's untied lm_head: odd N, f32 logits
    (528, 3584, 4608, False),   # Qwen2.5-7B prefill q|k|v
    (528, 18944, 3584, False),  # Qwen2.5-7B prefill down
])
def test_quantized_matmul_kernel_matches_plain(cuda_device, M, K, N, out_f32):
    from omni_avsr_tpu_torch.ops.quant import (
        arrange_for_card,
        quantized_matmul,
        quantized_matmul_plain,
    )

    x, q = _quant_inputs(M, K, N, cuda_device, seed=M + N)
    q = arrange_for_card(q)
    out_dtype = torch.float32 if out_f32 else None
    before = quantized_matmul.launches
    out = quantized_matmul(x, q, out_dtype=out_dtype)
    assert quantized_matmul.launches == before + 1
    ref = quantized_matmul_plain(x, q, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype and out.shape == (M, N)
    tol = dict(atol=1e-3, rtol=1e-3) if out_f32 else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.cuda
def test_quantized_matmul_biased_leaf(cuda_device):
    """A Qwen q|k|v leaf as the serving tree holds it: int8 codes in the
    card layout, the f32 scale and the bias, which `linear` adds after B2."""
    from omni_avsr_tpu_torch.models.common import linear
    from omni_avsr_tpu_torch.ops.quant import arrange_for_card, quantized_matmul_plain

    x, q = _quant_inputs(45, 3584, 4608, cuda_device, seed=11)
    g = torch.Generator(device=cuda_device).manual_seed(12)
    b = torch.randn(4608, generator=g, device=cuda_device).to(torch.bfloat16)
    leaf = arrange_for_card({**q, "b": b})
    assert set(leaf) == {"wc", "s", "b"}
    out = linear(x, leaf)
    ref = quantized_matmul_plain(x, leaf) + b
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_quantized_matmul_rejects_bad_input(cuda_device):
    """B2 never re-arranges weights per call: a leaf in the JAX layout, a
    card layout of another shape or an x that is not bf16 is refused."""
    from omni_avsr_tpu_torch.ops.quant import arrange_for_card, quantized_matmul

    x, q = _quant_inputs(45, 256, 384, cuda_device, seed=1)
    with pytest.raises(ValueError, match="card layout"):
        quantized_matmul(x, q)
    card = arrange_for_card(q)
    with pytest.raises(ValueError, match="does not hold"):
        quantized_matmul(x[:, :128].contiguous(), card)
    with pytest.raises(ValueError, match="dtype"):
        quantized_matmul(x.float(), card)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,out_f32", [
    (45, 2048, 3072, False),
    (45, 2048, 1101, True),    # odd N, not a multiple of block_n: padded last chunk
    (45, 2048, 128261, True),  # the lm_head: odd N, f32 logits
    (45, 8192, 2048, False),   # decode down: K split 8 ways
    (528, 2048, 16384, False),  # prefill (3 x 176): wgmma, 128-token tiles
    (3, 128, 512, False),
    (1, 2048, 3072, True),     # one token
    (64, 2048, 2048, False),   # the largest decode tile
    (65, 2048, 2048, True),    # one row past it: two 64-token tiles
    (4500, 1024, 4096, False),  # 256-token tiles
    (4500, 4096, 1024, True),
])
def test_quantized_matmul4_kernel_matches_plain(cuda_device, M, K, N, out_f32):
    from omni_avsr_tpu_torch.ops.quant import (
        arrange_for_card,
        pack_int4,
        quantized_matmul4,
        quantized_matmul4_plain,
    )

    x, q = _quant_inputs(M, K, N, cuda_device, seed=M + K, bits=4)
    q4 = arrange_for_card(pack_int4(q))  # the serving layout
    out_dtype = torch.float32 if out_f32 else None
    before = quantized_matmul4.launches
    out = quantized_matmul4(x, q4, out_dtype=out_dtype)
    assert quantized_matmul4.launches == before + 1
    assert quantized_matmul4.shapes[(M, K, N)] >= 1
    ref = quantized_matmul4_plain(x, q4, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype and out.shape == (M, N)
    tol = dict(atol=1e-3, rtol=1e-3) if out_f32 else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.cuda
def test_quantized_matmul4_rejects_jax_layout(cuda_device):
    """B6 never re-arranges weights per call: a packed leaf in the JAX
    layout is refused, the card layout of an int8 leaf too."""
    from omni_avsr_tpu_torch.ops.quant import (
        arrange_for_card,
        pack_int4,
        quantized_matmul4,
    )

    x, q = _quant_inputs(45, 256, 384, cuda_device, seed=2, bits=4)
    with pytest.raises(ValueError, match="card layout"):
        quantized_matmul4(x, pack_int4(q))
    with pytest.raises(ValueError, match="card layout"):
        quantized_matmul4(x, arrange_for_card(q))
    card = arrange_for_card(pack_int4(q))
    with pytest.raises(ValueError, match="does not hold"):
        quantized_matmul4(x[:, :128].contiguous(), card)


# B3: bf16 in and out; the kernel keeps the running sums in f32 and rounds
# the probabilities to bf16 once per key tile, the plain version once.
@pytest.mark.cuda
@pytest.mark.parametrize("B,T,S,Hq,Hkv,D,causal,lens,lse,rate", [
    (1, 1500, 1500, 16, 16, 64, False, None, False, 0.0),   # Whisper pad30s
    (3, 1500, 1500, 16, 16, 64, False, None, True, 0.0),    # Whisper pad30s, B 3, lse
    (3, 384, 384, 16, 16, 64, False, (300, 280, 260), False, 0.0),  # AV-HuBERT in (a)
    (2, 300, 300, 16, 16, 64, False, (300, 177), False, 0.0),  # AV-HuBERT, lengths
    (2, 512, 512, 16, 16, 64, True, None, False, 0.0),      # causal
    (2, 200, 200, 32, 8, 128, True, None, True, 0.0),       # causal, GQA, D 128, lse
    (2, 300, 300, 32, 8, 128, True, None, True, 0.0),       # the same at check_b3's T
    (4, 347, 347, 32, 8, 64, True, None, True, 0.0),        # the training LLM, GQA 32/8
    (4, 320, 320, 16, 16, 64, False, (320, 301, 280, 257), True, 0.1),  # AV-HuBERT training
    (2, 300, 300, 16, 16, 64, False, (300, 201), True, 0.1),  # dropout, lengths, lse
    (1, 130, 150, 4, 2, 64, True, (111,), True, 0.1),       # dropout, ragged tiles
    (2, 1000, 1000, 8, 8, 64, False, None, False, 0.0),     # T that no tile size divides
    (2, 37, 45, 8, 2, 64, True, None, True, 0.0),           # T < 64
    (3, 200, 260, 8, 8, 64, False, (260, 0, 5), True, 0.0),  # a zero length
    (2, 333, 333, 8, 8, 128, False, (333, 0), False, 0.2),   # D 128, zero length, dropout
])
def test_flash_attention_kernel_matches_plain(cuda_device, B, T, S, Hq, Hkv, D, causal, lens,
                                              lse, rate):
    from omni_avsr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    g = torch.Generator(device=cuda_device).manual_seed(T + S)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device).to(torch.bfloat16)

    q, k, v = rn(B, T, Hq, D), rn(B, S, Hkv, D), rn(B, S, Hkv, D)
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda_device) if lens else None
    kw = dict(causal=causal, kv_lengths=kv, return_lse=lse, dropout_rate=rate,
              dropout_seed=1234 if rate else None)
    before = flash_attention.launches
    out = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    ref = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    if lse:
        (out, out_lse), (ref, ref_lse) = out, ref
        torch.testing.assert_close(out_lse, ref_lse, atol=1e-3, rtol=1e-3)
    # a batch entry without keys: the kernel gives 0 where the plain version
    # averages v over the masked keys (the TPU kernel's value there depends
    # on its tiling); every other entry is held to the plain version
    keyed = [i for i in range(B) if lens is None or lens[i] > 0]
    for i in set(range(B)) - set(keyed):
        assert not bool(out[i].any())
    torch.testing.assert_close(out[keyed].float(), ref[keyed].float(), atol=2e-2, rtol=2e-2)


# B3 at a scale of 0 (uniform over the live keys) and below 0: masked keys
# (key lengths, the diagonal, a ragged last tile) stay out, lse included
@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.0, -0.125, -1.0])
@pytest.mark.parametrize("B,T,S,Hq,Hkv,D,causal,lens", [
    (2, 300, 300, 16, 16, 64, False, (300, 177)),
    (2, 200, 200, 32, 8, 128, True, None),
])
def test_flash_attention_kernel_any_scale(cuda_device, scale, B, T, S, Hq, Hkv, D, causal, lens):
    from omni_avsr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    g = torch.Generator(device=cuda_device).manual_seed(T + S)
    q, k, v = (torch.randn(B, n, h, D, generator=g, device=cuda_device).to(torch.bfloat16)
               for n, h in ((T, Hq), (S, Hkv), (S, Hkv)))
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda_device) if lens else None
    out, lse = flash_attention(q, k, v, scale=scale, causal=causal, kv_lengths=kv,
                               return_lse=True)
    ref, ref_lse = flash_attention_plain(q, k, v, scale=scale, causal=causal, kv_lengths=kv,
                                         return_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    with pytest.raises(ValueError, match="finite"):
        flash_attention(q, k, v, scale=float("inf"))


# B1 with one beam: greedy decoding's launch (K * G rows = 4 at GQA 32/8)
@pytest.mark.cuda
@pytest.mark.parametrize("B,P,step", [(3, 176, 0), (3, 176, 17), (1, 400, 31)])
def test_beam_attention_kernel_one_beam(cuda_device, B, P, step):
    inp = _beam_case(B, 1, 32, 8, 64, P, 32, cuda_device, seed=P + step)
    inp["anc"].zero_()  # greedy: row 0 at every slot
    before = beam_decode_attention.launches
    out = beam_decode_attention(**inp, step=step, num_beams=1)
    assert beam_decode_attention.launches == before + 1
    ref = beam_decode_attention_plain(**inp, step=step, num_beams=1)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


# B4: bf16 in and out; the kernels keep the probabilities in f32 and round
# p_drop and ds to bf16 per tile as the plain version does per element, and
# sum dk, dv over the GQA group in f32 where the plain version sums in one
# einsum: a bf16-level tolerance, as for B3.
@pytest.mark.cuda
@pytest.mark.parametrize("B,T,S,Hq,Hkv,D,causal,lens,rate", [
    (2, 320, 320, 16, 16, 64, False, (320, 201), 0.1),  # AV-HuBERT: lengths, dropout
    (2, 350, 350, 32, 8, 64, True, None, 0.0),          # the LLM: causal, GQA 32/8
    (1, 200, 200, 8, 8, 128, True, None, 0.0),          # D 128
    (2, 130, 150, 4, 2, 64, False, (150, 0), 0.25),     # ragged tiles, a row without keys
    (1, 96, 96, 4, 1, 64, True, (70,), 0.1),            # causal + lengths + dropout, G 4
    (2, 200, 200, 16, 4, 128, False, (200, 77), 0.1),   # G 4, D 128, lengths, dropout
    (3, 347, 347, 32, 8, 64, True, (347, 300, 12), 0.0),  # the LLM's shape with lengths
])
def test_flash_attention_bwd_kernel_matches_plain(cuda_device, B, T, S, Hq, Hkv, D, causal,
                                                  lens, rate):
    from omni_avsr_tpu_torch.ops.flash_attention import flash_attention
    from omni_avsr_tpu_torch.ops.flash_attention_bwd import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_trainable,
    )

    g = torch.Generator(device=cuda_device).manual_seed(T + S + D)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device).to(torch.bfloat16)

    q, k, v, do = rn(B, T, Hq, D), rn(B, S, Hkv, D), rn(B, S, Hkv, D), rn(B, T, Hq, D)
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda_device) if lens else None
    kw = dict(causal=causal, kv_lengths=kv, dropout_rate=rate, dropout_seed=4321 if rate else None)
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, do, lse, **kw)
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert bool(torch.isfinite(x.float()).all()), name
        torch.testing.assert_close(x.float(), y.float(), atol=2e-2, rtol=2e-2, msg=name)

    # the autograd route: B3 forward + B4 backward, one launch each
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    f_before = flash_attention.launches
    out = flash_attention_trainable(qs, ks, vs, **kw)
    out.backward(do)
    assert flash_attention.launches == f_before + 1
    assert flash_attention_bwd.launches == before + 2
    for name, t, y in zip(("dq", "dk", "dv"), (qs, ks, vs), want):
        torch.testing.assert_close(t.grad.float(), y.float(), atol=2e-2, rtol=2e-2, msg=name)


@pytest.mark.cuda
def test_flash_attention_bwd_rejects_bad_input(cuda_device):
    from omni_avsr_tpu_torch.ops.flash_attention_bwd import flash_attention_bwd

    t = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16, device=cuda_device)
    lse = torch.zeros(2, 64, dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_bwd(t.float(), t, t, t, t, lse)
    with pytest.raises(ValueError, match="head_dim"):
        s = t[..., :32].contiguous()
        flash_attention_bwd(s, s, s, s, s, lse)
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention_bwd(t, t, t, t, t, lse, dropout_rate=0.1)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        k3 = torch.zeros(1, 64, 3, 64, dtype=torch.bfloat16, device=cuda_device)
        flash_attention_bwd(t, k3, k3, t, t, lse)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_bwd(t, t, t, t.transpose(1, 2).contiguous().transpose(1, 2), t, lse)


# B5: chunk maxima and the row max are exact on both sides; the normaliser
# is summed in another order (per block, online against a running max).
@pytest.mark.cuda
@pytest.mark.parametrize("R,V", [(45, 128256), (8, 128256), (13, 16384), (1, 128), (3, 1280),
                                 (480, 128256)])
def test_row_stats_kernel_matches_plain(cuda_device, R, V):
    from omni_avsr_tpu_torch.ops.select_topk import row_stats_chunkmax, row_stats_chunkmax_plain

    g = torch.Generator(device=cuda_device).manual_seed(R + V)
    x = torch.randn(R, V, generator=g, device=cuda_device) * 4
    before = row_stats_chunkmax.launches
    cm, mx, se = row_stats_chunkmax(x)
    assert row_stats_chunkmax.launches == before + 1
    rcm, rmx, rse = row_stats_chunkmax_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(cm, rcm) and torch.equal(mx, rmx)
    torch.testing.assert_close(se, rse, atol=0.0, rtol=1e-5)


@pytest.mark.cuda
def test_row_stats_allocates_only_its_outputs(cuda_device):
    """One launch and no scratch tensor per call: after the first call
    (which makes the device's ticket buffer) a call allocates its three
    outputs and nothing else."""
    from omni_avsr_tpu_torch.ops.select_topk import row_stats_chunkmax

    x = torch.randn(45, 128256, device=cuda_device)
    row_stats_chunkmax(x)
    torch.cuda.synchronize()
    stats0, bytes0 = torch.cuda.memory_stats(), torch.cuda.memory_allocated()
    out = row_stats_chunkmax(x)
    stats1, bytes1 = torch.cuda.memory_stats(), torch.cuda.memory_allocated()
    assert stats1["allocation.all.allocated"] - stats0["allocation.all.allocated"] == 3
    assert bytes1 - bytes0 == sum(-(-t.numel() * 4 // 512) * 512 for t in out)


@pytest.mark.cuda
def test_row_stats_rejects_bad_input(cuda_device):
    from omni_avsr_tpu_torch.ops.select_topk import row_stats_chunkmax

    x = torch.zeros(4, 256, device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        row_stats_chunkmax(x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        row_stats_chunkmax(torch.zeros(256, 4, device=cuda_device).t())


# B7: bf16 operands, f32 accumulators on both sides; the kernel sums in
# another order and stores bf16 (or f32 for an f32 x).
@pytest.mark.cuda
@pytest.mark.parametrize("F,H,Cin,Cout,k,stride,pad,affine,act,res,x_f32", [
    (480, 22, 64, 64, 3, 1, 1, True, True, True, False),    # layer1 conv2
    (480, 22, 64, 128, 3, 2, 1, True, True, False, False),  # layer2 conv1
    (480, 22, 64, 128, 1, 2, 0, True, False, False, False),  # layer2 downsample
    (480, 3, 512, 512, 3, 1, 1, True, True, True, False),   # layer4 conv2, K 4608
    (37, 11, 128, 128, 3, 1, 1, False, False, False, False),  # raw train conv, ragged M
    (5, 7, 24, 40, 3, 2, 1, True, True, False, True),       # f32 x, Cin 24, Cout 40
    (3, 6, 16, 32, 1, 1, 0, True, False, True, True),       # f32 x and residual
    # the rest of the trunk's 13 geometries at 480 frames
    (480, 22, 64, 64, 3, 1, 1, True, True, False, False),   # layer1 conv1
    (480, 11, 128, 128, 3, 1, 1, True, True, True, False),  # layer2 conv2
    (480, 11, 128, 128, 3, 1, 1, True, True, False, False),  # layer2 b1 conv1
    (480, 11, 128, 256, 3, 2, 1, True, True, False, False),  # layer3 b0 conv1 s2
    (480, 11, 128, 256, 1, 2, 0, True, False, False, False),  # layer3 downsample
    (480, 6, 256, 256, 3, 1, 1, True, True, True, False),   # layer3 conv2
    (480, 6, 256, 256, 3, 1, 1, True, True, False, False),  # layer3 b1 conv1
    (480, 6, 256, 512, 3, 2, 1, True, True, False, False),  # layer4 b0 conv1 s2
    (480, 6, 256, 512, 1, 2, 0, True, False, False, False),  # layer4 downsample
    (480, 3, 512, 512, 3, 1, 1, True, True, False, False),  # layer4 b1 conv1
    (7, 5, 64, 128, 3, 1, 1, True, True, True, True),       # wgmma with f32 x and residual
])
def test_conv_block_kernel_matches_plain(cuda_device, F, H, Cin, Cout, k, stride, pad, affine,
                                         act, res, x_f32):
    from omni_avsr_tpu_torch.ops.conv_block import (
        FusedConv,
        conv2d_fused,
        conv2d_fused_plain,
        conv_plan,
    )

    g = torch.Generator(device=cuda_device).manual_seed(F + H + Cin + Cout + k)
    dt = torch.float32 if x_f32 else torch.bfloat16
    Ho = (H + 2 * pad - k) // stride + 1
    x = (torch.randn(F, H, H, Cin, generator=g, device=cuda_device) * 0.5).to(dt)
    w = (torch.randn(k, k, Cin, Cout, generator=g, device=cuda_device) * (2.0 / (k * k * Cin)) ** 0.5
         ).to(torch.bfloat16)
    scale = torch.rand(Cout, generator=g, device=cuda_device) + 0.5 if affine else None
    bias = torch.randn(Cout, generator=g, device=cuda_device) * 0.1 if affine else None
    a = torch.rand(Cout, generator=g, device=cuda_device) * 0.25 if act else None
    r = torch.randn(F, Ho, Ho, Cout, generator=g, device=cuda_device).to(dt) if res else None
    # Cin % 64 == 0 (and Cout % 64 == 0) takes the wgmma kernel, the rest
    # the mma.sync one
    plan = conv_plan(F, Ho, Ho, Cin, Cout, stride,
                     torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan.kernel == ("wgmma" if Cin % 64 == 0 and Cout % 64 == 0 else "mma")
    before = conv2d_fused.launches
    out = conv2d_fused(x, w, stride, pad, scale, bias, a, r)
    assert conv2d_fused.launches == before + 1
    ref = conv2d_fused_plain(x, w, stride, pad, scale, bias, a, r)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype == dt and out.shape == ref.shape == (F, Ho, Ho, Cout)
    tol = dict(atol=1e-3, rtol=1e-3) if x_f32 else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    # the autograd function's forward is the kernel
    y = FusedConv.apply(x, w, scale, bias, a, r, stride, pad)
    assert conv2d_fused.launches == before + 2
    torch.testing.assert_close(y.float(), out.float(), atol=0.0, rtol=0.0)


@pytest.mark.cuda
def test_conv_block_rejects_bad_input(cuda_device):
    from omni_avsr_tpu_torch.ops.conv_block import conv2d_fused

    x = torch.zeros(2, 8, 8, 12, dtype=torch.bfloat16, device=cuda_device)
    w = torch.zeros(3, 3, 12, 16, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="multiples of 8"):
        conv2d_fused(x, w, 1, 1)
    x16 = torch.zeros(2, 8, 8, 16, dtype=torch.float16, device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        conv2d_fused(x16, w[:, :, :1].expand(3, 3, 16, 16), 1, 1)
