#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`omni_avsr_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing lines with the elapsed seconds:
  1. the card: name and power limit, from nvidia-smi;
  2. the nvcc build of every kernel source in omni_avsr_tpu_torch/csrc/,
     one nvcc per source, all started together, and ptxas's registers,
     shared memory, spills and wgmma serialisation of the kernels on
     tensor cores (B3, B2/B6, B4, B1, B7);
  3. each kernel against its plain PyTorch version at the shapes the
     serving and training paths give it, with its time, the plain
     version's, a PyTorch library call's and the card's lower bound for
     the same work: B1 beam-decode attention (at the 6.4 s prefix and at
     the prefix of the 30 s-window requests below, with 15 beams, with
     the one beam of greedy decoding, and with 65 and 128 beams, more than
     one 64-bit live-beam mask word, and at (e)'s Qwen2.5-7B heads, 28
     over 4 at D 128; each timed case with its host time
     per call and the key splits `plan_splits` gave it), B3 flash attention (timed at
     Whisper's 30 s window at B 1 and B 3, AV-HuBERT at T 384 with the
     lengths of (a), the training LLM's causal GQA shape with lse and
     AV-HuBERT's training shape with lengths, dropout and lse, each beside
     SDPA and the kernels SDPA ran; and causal / key-length / GQA /
     D 128 / lse / dropout / scale 0 and -0.125 cases), B4 flash backward
     (AV-HuBERT's training shape with
     key lengths and dropout 0.1, the LLM's causal GQA shape; three calls
     under the profiler must run its two kernels and nothing else), B2 and
     B6 int8 and packed-int4 matmuls (every decode matrix, the lm_head with
     f32 logits, a tower matrix; in the card layouts of
     `arrange_for_card`), B5 the
     beam-selection row statistics (45
     rows of Llama-3's 128256-token vocabulary, and 8, 13 and 480 rows;
     one launch each, with the grid `row_plan` gave it), B7 the
     fused ResNet conv (each of the trunk's conv geometries and epilogues
     at 480 frames with its TFLOP/s and the kernel and tile `conv_plan`
     chose, summed over the 19 convs of one trunk);
  4. the full-width flagship (Whisper-medium, ResNet3D + AV-HuBERT-Large,
     Llama-3.2-1B with task-specific Omni-LoRA), random weights made on the
     card from a seed, served through `Transcriber.transcribe_many` with
     beam 15 and 32 new tokens in three configurations:
       (a) the default 30 s Whisper window, int8: 3 requests of 12.0, 11.2
           and 10.4 s (300, 280, 260 frames);
       (b) the bucketed window, int8: 3 requests of 6.4 s (160 frames);
       (c) the bucketed window, packed int4 LLM and int8 towers: as (b);
     and (b) once more with greedy decoding (`num_beams=1`, B1 at K = 1),
     and (b)'s first two requests at 65 beams (one warm and one measured
     batch), and one (b) batch through the evaluation entry point
     `OmniEngine.decode_batch` with babble (seeded, from numpy) mixed at
     0 dB SNR (`decode_snr_target=0.0`);
     then, with the earlier trees freed,
       (d) (b) with the LLM at Llama-3's base vocabulary of 128256 and both
           opt-in kernel routes on (`select_kernel=True`: B5 once per beam
           step; `conv_kernel=True`: B7 in the ResNet trunk's 19 convs);
       (e) (b) served by the registry's Qwen2.5-7B at full width and depth
           (`models/omni.py::registry_model`: 28 layers, hidden 3584, 28/4
           heads at D 128, FFN 18944, q/k/v bias, untied head, Qwen2.5's
           151643-token vocabulary plus the specials), int8; then one
           request through `Transcriber.transcribe`, its transcript
           printed.
     For each, one warm batch and 5 measured ones (3 for greedy; the
     median reported); every kernel counter is set to 0 just before each
     measured batch, read just after, and held to the count the path must
     give;
  5. B2 at every distinct (M, K, N) that one measured batch of (a), (b)
     and (e) launched it with, and B6 at every one of a (c) batch (the wrappers
     count launches by shape), each against its plain version, timed beside
     cuBLAS's bf16 product and the bound, and summed over the batch's
     tower, prefill and decode launches;
     then reference checks at full width: the prefill and the first decode
     steps through the kernels and through the plain versions (int8 and
     int4, and (e)'s Qwen2.5-7B), one Whisper layer at T = 1500 through B3 and through its
     plain version, the ResNet of (d)'s batch (480 frames) through B7 and
     through its plain version, and B5 on the logits of (d)'s first decode
     step against its plain version;
  6. where the device time goes, one profiled batch per configuration;
  7. training: `OmniEngine.train_step` on the full-width flagship (30 s
     Whisper window, random weights from a seed, augmentation with a
     babble bank made with numpy from a seed), 4 clips of 320 frames
     (12.8 s) with 15-token transcripts, rates pinned to (4, 2) so that
     both of B4's sites run (AV-HuBERT at T 320, the audiovisual task's LLM
     sequence of ~350): one warm step and 3 measured ones, the B3 and B4
     launches of each held to the count the path must give; then one
     step's loss and trainable grads through the kernels and through the
     plain B3/B4, with the same random draws; then the first step once more
     on a fresh engine with `conv_kernel=True` (B7 in the ResNet's raw
     train-mode convs, 19 launches), its loss beside the first step's.
Then a `kernels` JSON line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failure raises and exits non-zero; without a CUDA device the script
exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

T0 = time.perf_counter()
DEV = "cuda"

# B1 at the serving shapes: beams, new tokens, heads, head dim, and the
# prefix slots of the bucketed 6.4 s requests (172 tokens, rounded up to 16)
K, N, HQ, HKV, D, P_BUCKET = 15, 32, 32, 8, 64, 176
B_SERVE = 3  # the three requests decode as one batch
# bf16 inputs and outputs: the kernels keep probabilities or partial sums in
# f32 where the plain versions round them to bf16 (or sum in another order)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
F32_OUT_TOL = dict(atol=2e-3, rtol=2e-3)  # f32 logits of the lm_head
REL_L2_TOL = 2e-2  # full-width routes, kernel vs plain
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12  # H100 SXM dense bf16
# the Llama-3.2-1B decode matrices (K, N); the lm_head is (2048, vocab)
DECODE_MATS = [("qkv", 2048, 3072), ("o", 2048, 2048), ("gateup", 2048, 16384),
               ("down", 8192, 2048)]
TOWER_MAT = ("tower fc1", 4500, 1024, 4096)  # M = 3 x 1500 at the 30 s window


def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {phase}: {msg}", flush=True)


def time_ms(fn, flush, iters: int = 50) -> float:
    """Mean device time of one call, each call started with a cold L2 (the
    serving loop streams other weights between two calls at one shape). A
    sleep kernel first holds the stream while the host queues every call,
    so the events bracket device work, not the host's launch overhead."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda._sleep(200_000_000)  # ~0.1 s at 1.98 GHz, longer than the queueing
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def host_ms(fn, iters: int = 50, repeats: int = 1) -> float:
    """Wall time per call of back-to-back calls, host launch overhead
    included (what a host-bound decode loop pays); the median of `repeats`
    runs of `iters` calls (the host clock of a shared machine spreads)."""
    import torch

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t) * 1e3 / iters)
    return sorted(runs)[len(runs) // 2]


def bound_ms(nbytes: float, flops: float):
    """The least time for the work: bytes over HBM bandwidth or operations
    over the bf16 peak, whichever is larger, and which one it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# --------------------------------------------------------------------- B1


def b1_inputs(B: int, P: int, step: int, seed: int, K: int = K, heads=(HQ, HKV, D)):
    """B1's inputs at B batch items x K beams, prefix P, and `heads` = (query
    heads, kv heads, head dim)."""
    import torch

    HQ, HKV, D = heads
    g = torch.Generator(device=DEV).manual_seed(seed)
    dev, bf = DEV, torch.bfloat16

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    BK = B * K
    prefix_mask = torch.rand(B, P, generator=g, device=dev) < 0.95
    prefix_mask[:, 0] = True
    return dict(
        q=rn(BK, 1, HQ, D), pk=rn(B, HKV, P, D), pv=rn(B, HKV, P, D),
        gk=rn(B, HKV, K, N, D), gv=rn(B, HKV, K, N, D), k_cur=rn(BK, HKV, D), v_cur=rn(BK, HKV, D),
        prefix_bias=torch.where(prefix_mask, 0.0, -0.7 * torch.finfo(torch.float32).max).float(),
        anc=torch.randint(0, K, (B, K, N), generator=g, device=dev, dtype=torch.int32),
    )


def b1_bound_ms(inp, step: int) -> float:
    """Each input byte the result depends on read once (the live generated
    entries only), the output written once; the operations are ~1000x
    below the bf16 peak."""
    q, anc = inp["q"], inp["anc"]
    B, HKV, P, D = inp["pk"].shape
    HQ = q.shape[2]
    live_rows = sum(len({(int(r), n) for n in range(step) for r in anc[b, :, n].tolist()})
                    for b in range(B))
    byte = 2
    nbytes = (2 * q.numel() * byte                        # q and out
              + 2 * B * HKV * P * D * byte                # prefix K and V
              + 2 * live_rows * HKV * D * byte            # live generated K and V
              + 2 * inp["k_cur"].numel() * byte           # current K and V
              + inp["prefix_bias"].numel() * 4 + anc.numel() * 4)
    flops = 4 * q.shape[0] * HQ * D * (P + step + 1)
    return bound_ms(nbytes, flops)[0]


def sdpa_on_reordered_cache(inp, step: int):
    """The library yardstick: one scaled_dot_product_attention call with an
    explicit mask over the physically reordered cache [prefix | beam's
    ancestor chain | current token]. Set-up is outside the timed call."""
    import torch
    import torch.nn.functional as F

    q, anc = inp["q"], inp["anc"]
    B, HKV, P, D = inp["pk"].shape
    K, HQ = anc.shape[1], q.shape[2]
    BK = B * K
    G = HQ // HKV
    b_idx = torch.arange(B, device=DEV)[:, None, None]
    n_idx = torch.arange(N, device=DEV)[None, None, :]

    def keys(prefix, gen, cur):
        pre = prefix[:, None].expand(B, K, HKV, P, D).reshape(BK, HKV, P, D)
        chain = gen.permute(0, 2, 3, 1, 4)[b_idx, anc.long(), n_idx]  # (B, K, N, Hkv, D)
        chain = chain.permute(0, 1, 3, 2, 4).reshape(BK, HKV, N, D)
        full = torch.cat([pre, chain, cur[:, :, None]], dim=2)
        return full.repeat_interleave(G, dim=1).contiguous()  # (BK, Hq, S, D)

    k = keys(inp["pk"], inp["gk"], inp["k_cur"])
    v = keys(inp["pv"], inp["gv"], inp["v_cur"])
    qh = q.reshape(BK, HQ, 1, D)
    valid = torch.cat([
        (inp["prefix_bias"] == 0).repeat_interleave(K, dim=0),
        (torch.arange(N, device=DEV) < step)[None].expand(BK, N),
        torch.ones(BK, 1, dtype=torch.bool, device=DEV),
    ], dim=1)[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=valid)


def check_b1(flush, P: int, batches=(1, B_SERVE, 4), K: int = K, heads=(HQ, HKV, D)):
    """B1 against its plain version (and SDPA on the reordered cache) at
    prefix P with K beams and `heads` (query heads, kv heads, head dim);
    returns the timed row at B 3, step 17."""
    import torch

    from omni_avsr_tpu_torch import kernels
    from omni_avsr_tpu_torch.ops.beam_attention import (
        beam_decode_attention,
        beam_decode_attention_plain,
        plan_splits,
    )

    max_err, timed = 0.0, None
    for B in batches:
        for step in (0, 17, 31, N):
            inp = b1_inputs(B, P, step, seed=100 * B + step + P + K, K=K, heads=heads)
            out = beam_decode_attention(**inp, step=step, num_beams=K)
            ref = beam_decode_attention_plain(**inp, step=step, num_beams=K)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
            sdpa = sdpa_on_reordered_cache(inp, step)().reshape(out.shape)
            torch.testing.assert_close(out.float(), sdpa.float(), **BF16_TOL)
            max_err = max(max_err, err)
            if B != B_SERVE or step != 17:
                continue
            kernel = lambda: beam_decode_attention(**inp, step=step, num_beams=K)  # noqa: E731
            timed = dict(P=P, B=B, step=step, ms=time_ms(kernel, flush),
                         host_ms=host_ms(kernel, iters=200, repeats=5),
                         plain_ms=time_ms(lambda: beam_decode_attention_plain(
                             **inp, step=step, num_beams=K), flush),
                         library_ms=time_ms(sdpa_on_reordered_cache(inp, step), flush),
                         bound_ms=b1_bound_ms(inp, step), bound_by="bytes",
                         splits=plan_splits(B, heads[1], K * (heads[0] // heads[1]), P, K,
                                            step, kernels.sm_count(torch.device(DEV))))
    timed["max_abs_err"] = max_err
    timed["K"] = K
    timed["heads"] = dict(Hq=heads[0], Hkv=heads[1], G=heads[0] // heads[1], D=heads[2])
    log("B1", f"kernel vs plain at P {P}, K {K}, Hq {heads[0]} / Hkv {heads[1]}, D {heads[2]}, "
        f"B {list(batches)} x step 0/17/31/{N}: max_abs_err "
        f"{max_err:.3g} (tol atol/rtol 2e-2); timed at B 3 step 17: {json.dumps(timed)}")
    return timed


# --------------------------------------------------------------------- B3


def sdpa_backend(run) -> list:
    """The device kernels that one call of `run` (an SDPA call) launches:
    which backend PyTorch picked for it."""
    names = []
    for name, _ in device_activities(run):
        short = re.sub(r"\(.*", "", name)[:90]
        if short not in names:
            names.append(short)
    return names


def check_b3(flush):
    """B3 against its plain version: the timed shapes of the serving and
    training paths (each against SDPA, with a boolean key mask where there
    are lengths, and the bound from the (query, key) pairs the masks leave)
    and more cases for correctness. Returns the Whisper B 3 row and the
    timed rows."""
    import torch
    import torch.nn.functional as F

    from omni_avsr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    seed = 20261017
    cases = [  # name, B, T, S, Hq, Hkv, D, options, timed
        ("whisper pad30s B1", 1, 1500, 1500, 16, 16, 64, {}, True),
        ("whisper pad30s B3", B_SERVE, 1500, 1500, 16, 16, 64, {}, True),
        ("avhubert T 384 B3 lengths (a)", B_SERVE, 384, 384, 16, 16, 64,
         dict(kv_lengths=(300, 280, 260)), True),
        (f"llm causal T {T_LLM_AV} B4 GQA 32/8 lse (train)", B_TRAIN, T_LLM_AV, T_LLM_AV, 32, 8,
         64, dict(causal=True, return_lse=True), True),
        (f"avhubert T {FRAMES_TRAIN} B4 lengths dropout 0.1 lse (train)", B_TRAIN, FRAMES_TRAIN,
         FRAMES_TRAIN, 16, 16, 64, dict(kv_lengths=(320, 301, 280, 257), dropout_rate=0.1,
                                        dropout_seed=seed, return_lse=True), True),
        ("causal", 2, 512, 512, 16, 16, 64, dict(causal=True), False),
        ("kv_lengths", 3, 384, 384, 16, 16, 64, dict(kv_lengths=(384, 300, 257)), False),
        ("GQA 32/8 D128 causal lse", 2, 300, 300, 32, 8, 128,
         dict(causal=True, return_lse=True), False),
        ("dropout 0.1 lse lengths", 2, 300, 300, 16, 16, 64,
         dict(dropout_rate=0.1, dropout_seed=seed, return_lse=True, kv_lengths=(300, 201)), False),
        ("scale 0 lse lengths", 2, 300, 300, 16, 16, 64,
         dict(scale=0.0, return_lse=True, kv_lengths=(300, 201)), False),
        ("scale -0.125 causal lse lengths", 2, 300, 300, 16, 16, 64,
         dict(scale=-0.125, causal=True, return_lse=True, kv_lengths=(300, 201)), False),
    ]
    max_err, main_row, timed_rows = 0.0, None, []
    for name, B, T, S, Hq, Hkv, Dh, opts, timed in cases:
        g = torch.Generator(device=DEV).manual_seed(T + S + Hq + Dh)

        def rn(*shape):
            return torch.randn(*shape, generator=g, device=DEV).to(torch.bfloat16)

        q, k, v = rn(B, T, Hq, Dh), rn(B, S, Hkv, Dh), rn(B, S, Hkv, Dh)
        lens = opts.get("kv_lengths")
        if lens is not None:
            opts = {**opts, "kv_lengths": torch.tensor(lens, dtype=torch.int32, device=DEV)}
        out = flash_attention(q, k, v, **opts)
        ref = flash_attention_plain(q, k, v, **opts)
        torch.cuda.synchronize()
        if opts.get("return_lse"):
            (out, lse), (ref, ref_lse) = out, ref
            torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
        if not bool(torch.isfinite(out.float()).all()):
            raise RuntimeError(f"B3 {name}: non-finite output")
        err = (out.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
        max_err = max(max_err, err)
        row = dict(case=name, B=B, T=T, S=S, Hq=Hq, Hkv=Hkv, D=Dh, causal=bool(opts.get("causal")),
                   kv_lengths=list(lens) if lens else None, dropout=opts.get("dropout_rate", 0.0),
                   lse=bool(opts.get("return_lse")), scale=opts.get("scale"), max_abs_err=err)
        if timed:
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            mask = None
            if lens is not None:
                mask = (torch.arange(S, device=DEV)[None, :] < opts["kv_lengths"][:, None])[
                    :, None, None, :]
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qh, kh, vh, attn_mask=mask, dropout_p=opts.get("dropout_rate", 0.0),
                is_causal=row["causal"], enable_gqa=Hq != Hkv)
            pairs = valid_pairs(T, S, row["causal"], lens or (S,) * B)
            nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + (4 * B * Hq * T if row["lse"]
                                                                      else 0)
            row.update(
                ms=time_ms(lambda: flash_attention(q, k, v, **opts), flush),
                plain_ms=time_ms(lambda: flash_attention_plain(q, k, v, **opts), flush, iters=10),
                library_ms=time_ms(sdpa, flush), library_kernels=sdpa_backend(sdpa),
                valid_pairs=pairs)
            row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 4.0 * Dh * Hq * pairs)
            row["tflop_per_s"] = 4.0 * Dh * Hq * pairs / (row["ms"] * 1e-3) / 1e12
            if name == "whisper pad30s B3":
                main_row = row
            timed_rows.append(row)
        log("B3", json.dumps(row))
    main_row["max_abs_err"] = max_err
    return main_row, timed_rows


# --------------------------------------------------------------------- B4

# the training phase's shapes: 4 clips of 320 frames; the audiovisual
# task's LLM sequence is BOS + audio sos/eos around 650/4 tokens + video
# sos/eos around 320/2 tokens + the 6-token prompt + 14 text tokens
B_TRAIN, FRAMES_TRAIN, TOKENS_TRAIN = 4, 320, 15
T_LLM_AV = 1 + (2 + 650 // 4) + (2 + FRAMES_TRAIN // 2) + 6 + (TOKENS_TRAIN - 1)


def valid_pairs(T: int, S: int, causal: bool, lens) -> int:
    """(query, key) pairs the masks leave, summed over the batch."""
    total = 0
    for n in lens:
        if causal:
            total += sum(min(i + 1, n) for i in range(T))
        else:
            total += T * n
    return total


def check_b4(flush):
    """B4 against its plain version at the training phase's two shapes, both
    timed against the backward of scaled_dot_product_attention (a
    yardstick; the port never calls it) and the bound. Returns the rows."""
    import torch
    import torch.nn.functional as F

    from omni_avsr_tpu_torch.ops.flash_attention import flash_attention
    from omni_avsr_tpu_torch.ops.flash_attention_bwd import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
    )

    cases = [  # name, B, T, Hq, Hkv, causal, kv lengths, dropout
        ("avhubert T 320 lengths dropout 0.1", B_TRAIN, FRAMES_TRAIN, 16, 16, False,
         (320, 301, 280, 257), 0.1),
        (f"llm causal T {T_LLM_AV} GQA 32/8", B_TRAIN, T_LLM_AV, 32, 8, True, None, 0.0),
    ]
    rows = []
    for name, B, T, Hq, Hkv, causal, lens, rate in cases:
        g = torch.Generator(device=DEV).manual_seed(T + Hq)

        def rn(*shape):
            return torch.randn(*shape, generator=g, device=DEV).to(torch.bfloat16)

        q, k, v, do = rn(B, T, Hq, D), rn(B, T, Hkv, D), rn(B, T, Hkv, D), rn(B, T, Hq, D)
        kv = torch.tensor(lens, dtype=torch.int32, device=DEV) if lens else None
        kw = dict(causal=causal, kv_lengths=kv, dropout_rate=rate,
                  dropout_seed=20261017 if rate else None)
        o, lse = flash_attention(q, k, v, return_lse=True, **kw)
        got = flash_attention_bwd(q, k, v, o, do, lse, **kw)
        want = flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
        torch.cuda.synchronize()
        errs = {}
        for label, x, y in zip(("dq", "dk", "dv"), got, want):
            if not bool(torch.isfinite(x.float()).all()):
                raise RuntimeError(f"B4 {name}: non-finite {label}")
            torch.testing.assert_close(x.float(), y.float(), **BF16_TOL)
            errs[label] = (x.float() - y.float()).abs().max().item()
        # the library yardstick: SDPA's backward at the same shape and masks
        qh, kh, vh = (t.transpose(1, 2).detach().clone().requires_grad_(True) for t in (q, k, v))
        mask = None
        if lens:
            mask = (torch.arange(T, device=DEV)[None, :] < kv[:, None])[:, None, None, :]
        out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, dropout_p=rate,
                                             is_causal=causal, enable_gqa=Hq != Hkv)
        doh = do.transpose(1, 2)
        n_lens = lens if lens else (T,) * B
        nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()  # q o do dq, k v dk dv
        flops = 10.0 * D * Hq * valid_pairs(T, T, causal, n_lens)
        row = dict(case=name, B=B, T=T, S=T, Hq=Hq, Hkv=Hkv, D=D, causal=causal,
                   kv_lengths=list(lens) if lens else None, dropout=rate,
                   max_abs_err=max(errs.values()), max_abs_err_each=errs,
                   ms=time_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, **kw), flush),
                   plain_ms=time_ms(lambda: flash_attention_bwd_plain(q, k, v, o, do, lse, **kw),
                                    flush, iters=10),
                   library_ms=time_ms(lambda: torch.autograd.grad(
                       out, (qh, kh, vh), doh, retain_graph=True), flush))
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
        row["bytes_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        row["operations_bound_ms"] = flops / BF16_FLOPS * 1e3
        # the wrapper allocates and launches its two kernels, and runs no other
        # op: three warm calls under the profiler show those two names alone
        acts = device_activities(lambda: [flash_attention_bwd(q, k, v, o, do, lse, **kw)
                                          for _ in range(3)], least=6)
        by_name: dict = {}
        for n, us in acts:
            by_name.setdefault((re.search(r"(\w+)<", n) or re.search(r"(\w+)\(", n)).group(1),
                               []).append(us)
        if sorted(by_name) != ["flash_bwd_dkv_kernel", "flash_bwd_dq_kernel"] or len(acts) > 6:
            raise RuntimeError(f"B4 {name}: three calls ran the device work {acts}, not the "
                               f"two kernels alone")
        row["device_kernels_us"] = {n: sum(v) / len(v) for n, v in by_name.items()}
        log("B4", json.dumps(row))
        rows.append(row)
        profile_batch(f"B4 {name}", lambda: flash_attention_bwd(q, k, v, o, do, lse, **kw))
    return rows


# ---------------------------------------------------------------- B2, B6


def check_qmm(flush, int4: bool, vocab: int):
    """B2 (int8) or B6 (packed int4) against its plain version at every
    decode matrix (M 45), the lm_head (f32 logits) and one tower matrix;
    also timed: the route the port had before B2 (dequantise to f32, f32
    torch.matmul) and, as the library yardstick, torch.matmul in bf16 on a
    weight dequantised beforehand (it reads 2 bytes per weight where the
    kernels read 1 or 1/2). Returns one decode step's sums: 16 layers x
    (qkv, o, gateup, down) + the lm_head."""
    import torch

    from omni_avsr_tpu_torch.ops.quant import (
        quantized_matmul,
        quantized_matmul4,
        quantized_matmul4_plain,
        quantized_matmul_plain,
    )

    label = "B6" if int4 else "B2"
    kernel = quantized_matmul4 if int4 else quantized_matmul
    plain = quantized_matmul4_plain if int4 else quantized_matmul_plain
    shapes = [(n, 45, k, nn) for n, k, nn in DECODE_MATS] + [("lm_head", 45, 2048, vocab)]
    shapes.append(TOWER_MAT)
    step = dict(ms=0.0, plain_ms=0.0, old_route_ms=0.0, library_ms=0.0, bound_ms=0.0,
                nbytes=0.0, flops=0.0)
    max_err = 0.0
    for name, M, Kd, Nd in shapes:
        g = torch.Generator(device=DEV).manual_seed(M + Kd + Nd)
        w = torch.randn(Kd, Nd, generator=g, device=DEV) * 0.02
        x = torch.randn(M, Kd, generator=g, device=DEV).to(torch.bfloat16)
        q, leaf = serving_leaf(w, 4 if int4 else 8)
        del w
        out_dtype = torch.float32 if name == "lm_head" else None
        out = kernel(x, leaf, out_dtype=out_dtype)
        ref = plain(x, leaf, out_dtype=out_dtype)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(),
                                   **(F32_OUT_TOL if out_dtype else BF16_TOL))
        max_err = max(max_err, err)
        w_bf16 = (q["w"].float() * q["s"]).to(torch.bfloat16)
        codes, s = q["w"], q["s"]
        wbytes = Kd * Nd // 2 if int4 else Kd * Nd
        nbytes = M * Kd * 2 + wbytes + Nd * 4 + M * Nd * (4 if out_dtype else 2)
        flops = 2.0 * M * Kd * Nd
        row = dict(shape=name, M=M, K=Kd, N=Nd, max_abs_err=err,
                   ms=time_ms(lambda: kernel(x, leaf, out_dtype=out_dtype), flush),
                   plain_ms=time_ms(lambda: plain(x, leaf, out_dtype=out_dtype), flush, iters=20),
                   old_route_ms=time_ms(lambda: x.float() @ (codes.float() * s), flush, iters=20),
                   library_ms=time_ms(lambda: x @ w_bf16, flush))
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
        log(label, json.dumps(row))
        if name == TOWER_MAT[0]:
            step["tower"] = row
        else:
            reps = 1 if name == "lm_head" else 16
            for key in ("ms", "plain_ms", "old_route_ms", "library_ms", "bound_ms"):
                step[key] += reps * row[key]
            step["nbytes"] += reps * nbytes
            step["flops"] += reps * flops
        del x, q, leaf, w_bf16, codes, out, ref
    step["bound_by"] = bound_ms(step["nbytes"], step["flops"])[1]
    step["max_abs_err"] = max_err
    log(label, f"one decode step (16 x qkv, o, gateup, down + lm_head, M 45): kernel "
        f"{step['ms']:.4f} ms, plain {step['plain_ms']:.4f} ms, old route (dequantise + f32 "
        f"matmul) {step['old_route_ms']:.4f} ms, bf16 torch.matmul on a dequantised weight "
        f"(2 bytes per weight) {step['library_ms']:.4f} ms, "
        f"bound {step['bound_ms']:.4f} ms ({step['bound_by']}); max_abs_err {max_err:.3g}")
    return step


def serving_leaf(w, bits: int):
    """The codes of a float weight and its leaf as the serving tree holds it
    on the card: int8 in B2's card layout, packed int4 in B6's."""
    from omni_avsr_tpu_torch.ops.quant import arrange_for_card, pack_int4, quantize_per_channel

    q = quantize_per_channel(w, bits=bits)
    return q, arrange_for_card(pack_int4(q) if bits == 4 else q)


def b2_stage(M: int, Kd: int, Nd: int, vocab: int, llm_dims) -> str:
    """Which stage of a served batch runs B2 or B6 at (M, K, N): the decode
    steps (M = 3 requests x 15 beams, with their lm_head), the LLM prefill
    (the LLM's widths, and the lm_head of the last prefix token) or the
    towers."""
    if M == B_SERVE * K:
        return "decode"
    if Nd == vocab or Kd in llm_dims:
        return "prefill"
    return "tower"


def qmm_per_batch(flush, label: str, shapes, vocab: int, llm_dims, bits: int = 8):
    """B2 (bits 8) or B6 (bits 4) at every distinct (M, K, N) that one
    served batch launched it with, each against its plain version, timed
    (cold L2) beside the plain version, cuBLAS's bf16 product on the weight
    dequantised beforehand and the bound; summed over the batch's launches
    by stage.
    Returns {stage: sums} and the shape rows."""
    import torch

    from omni_avsr_tpu_torch.ops.quant import (
        quantized_matmul,
        quantized_matmul4,
        quantized_matmul4_plain,
        quantized_matmul_plain,
    )

    kernel = quantized_matmul4 if bits == 4 else quantized_matmul
    plain = quantized_matmul4_plain if bits == 4 else quantized_matmul_plain
    name = "B6" if bits == 4 else "B2"

    sums = {st: dict(launches=0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, nbytes=0.0,
                     flops=0.0)
            for st in ("tower", "prefill", "decode", "batch")}
    rows = []
    for (M, Kd, Nd), count in shapes:
        g = torch.Generator(device=DEV).manual_seed(M + Kd + Nd)
        w = torch.randn(Kd, Nd, generator=g, device=DEV) * 0.02
        x = torch.randn(M, Kd, generator=g, device=DEV).to(torch.bfloat16)
        q, leaf = serving_leaf(w, bits)
        del w
        w_bf16 = (q["w"].float() * q["s"]).to(torch.bfloat16)
        del q
        out_dtype = torch.float32 if Nd == vocab else None
        out = kernel(x, leaf, out_dtype=out_dtype)
        ref = plain(x, leaf, out_dtype=out_dtype)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(),
                                   **(F32_OUT_TOL if out_dtype else BF16_TOL))
        nbytes = M * Kd * 2 + Kd * Nd * bits // 8 + Nd * 4 + M * Nd * (4 if out_dtype else 2)
        flops = 2.0 * M * Kd * Nd
        stage = b2_stage(M, Kd, Nd, vocab, llm_dims)
        row = dict(stage=stage, M=M, K=Kd, N=Nd, launches=count,
                   max_abs_err=(out.float() - ref.float()).abs().max().item(),
                   ms=time_ms(lambda: kernel(x, leaf, out_dtype=out_dtype), flush),
                   plain_ms=time_ms(lambda: plain(x, leaf, out_dtype=out_dtype), flush, iters=20),
                   library_ms=time_ms(lambda: x @ w_bf16, flush))
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
        rows.append(row)
        log(name, f"{label}: {json.dumps(row)}")
        for st in (stage, "batch"):
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                sums[st][key] += count * row[key]
            sums[st]["launches"] += count
            sums[st]["nbytes"] += count * nbytes
            sums[st]["flops"] += count * flops
        del x, leaf, w_bf16, out, ref
    torch.cuda.empty_cache()
    for st, v in sums.items():
        v["bound_by"] = bound_ms(v["nbytes"], v["flops"])[1] if v["launches"] else None
        log(name, f"{label}, one batch, {st}: {v['launches']} launches, kernel "
            f"{v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, cuBLAS bf16 {v['library_ms']:.4f} ms, "
            f"bound {v['bound_ms']:.4f} ms ({v['bound_by']})")
    return sums, rows


# ------------------------------------------------------------------ B5, B7

VOCAB_D = 128256  # Llama-3's base vocabulary: configuration (d)
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
# (d)'s 3 x 15 beams first (timed), 8 rows, a row count not a multiple of 8,
# and 32 x 15 beams, the shape of the JAX package's selection benchmark
B5_ROWS = (B_SERVE * K, 8, 13, 480)


def b5_agreement(x):
    """B5 against its plain version on x: chunk and row maxima bit for bit,
    the normaliser at rtol 1e-5 (summed in another order). Returns the
    largest absolute difference of the three outputs."""
    import torch

    from omni_avsr_tpu_torch.ops.select_topk import row_stats_chunkmax, row_stats_chunkmax_plain

    got = row_stats_chunkmax(x)
    want = row_stats_chunkmax_plain(x)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError(f"B5 at {tuple(x.shape)}: chunk or row maxima differ from the plain version")
    torch.testing.assert_close(got[2], want[2], atol=0.0, rtol=1e-5)
    return max((a - b).abs().max().item() for a, b in zip(got, want))


def check_b5(flush):
    """B5 at (d)'s selection shape and two more row counts, timed at (d)'s
    against the plain version and torch.logsumexp (which computes only the
    normaliser of the three outputs), and the bound: each logit read once,
    the statistics written once."""
    import torch

    from omni_avsr_tpu_torch import kernels
    from omni_avsr_tpu_torch.ops.select_topk import (
        row_plan,
        row_stats_chunkmax,
        row_stats_chunkmax_plain,
    )

    max_err, timed = 0.0, None
    for R in B5_ROWS:
        g = torch.Generator(device=DEV).manual_seed(R)
        x = torch.randn(R, VOCAB_D, generator=g, device=DEV) * 4
        err = b5_agreement(x)
        max_err = max(max_err, err)
        if R != B5_ROWS[0]:
            continue
        C = VOCAB_D // 128
        nbytes = 4 * (R * VOCAB_D + R * C + 2 * R)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 4.0 * R * VOCAB_D / F32_FLOPS  # max, sub, exp, add
        timed = dict(R=R, V=VOCAB_D, ms=time_ms(lambda: row_stats_chunkmax(x), flush),
                     host_ms=host_ms(lambda: row_stats_chunkmax(x)),
                     plain_ms=time_ms(lambda: row_stats_chunkmax_plain(x), flush),
                     library_ms=time_ms(lambda: torch.logsumexp(x, dim=-1), flush),
                     library_call="torch.logsumexp (the normaliser only)",
                     bound_ms=max(t_bytes, t_ops) * 1e3,
                     bound_by="bytes" if t_bytes >= t_ops else "operations",
                     parts_per=row_plan(R, C, kernels.sm_count(torch.device(DEV))))
    timed["max_abs_err"] = max_err
    log("B5", f"kernel vs plain at R {list(B5_ROWS)} x V {VOCAB_D}: maxima bit-equal, normaliser "
        f"within rtol 1e-5, max_abs_err {max_err:.3g}; timed: {json.dumps(timed)}")
    return timed


def trunk_convs(frames: int):
    """The ResNet trunk's 19 convs after the 88x88 crop, stem and pool
    (22x22x64), as (label, F, H, Cin, Cout, k, stride, pad, affine, act,
    residual, count): each distinct geometry and epilogue once, with the
    number of convs of one eval-mode trunk that have it."""
    convs = [("layer1 conv1", frames, 22, 64, 64, 3, 1, 1, True, True, False, 2),
             ("layer1 conv2", frames, 22, 64, 64, 3, 1, 1, True, True, True, 2)]
    h, c = 22, 64
    for name in ("layer2", "layer3", "layer4"):
        ho = (h + 1) // 2
        convs += [(f"{name} b0 conv1 s2", frames, h, c, 2 * c, 3, 2, 1, True, True, False, 1),
                  (f"{name} downsample", frames, h, c, 2 * c, 1, 2, 0, True, False, False, 1),
                  (f"{name} conv2", frames, ho, 2 * c, 2 * c, 3, 1, 1, True, True, True, 2),
                  (f"{name} b1 conv1", frames, ho, 2 * c, 2 * c, 3, 1, 1, True, True, False, 1)]
        h, c = ho, 2 * c
    assert sum(cv[-1] for cv in convs) == 19
    return convs


def check_b7(flush, frames: int = 3 * 160):
    """B7 against its plain version at every trunk conv of (d)'s batch (480
    frames) and at the raw train-mode conv, timed against the plain version,
    cuDNN's bf16 conv in channels_last with the epilogue as torch ops, and
    the bound. Returns one trunk's sums (19 convs)."""
    import torch
    import torch.nn.functional as F

    from omni_avsr_tpu_torch import kernels
    from omni_avsr_tpu_torch.ops.conv_block import conv2d_fused, conv2d_fused_plain, conv_plan

    trunk = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, nbytes=0.0, flops=0.0)
    max_err, rows = 0.0, []
    cases = trunk_convs(frames) + [("raw train conv (layer2 conv2)", frames, 11, 128, 128, 3, 1,
                                    1, False, False, False, 0)]
    for label, Fr, H, Cin, Cout, k, stride, pad, affine, act, res, count in cases:
        g = torch.Generator(device=DEV).manual_seed(H * Cin + Cout + k)
        Ho = (H + 2 * pad - k) // stride + 1
        x = (torch.randn(Fr, H, H, Cin, generator=g, device=DEV) * 0.5).to(torch.bfloat16)
        w = (torch.randn(k, k, Cin, Cout, generator=g, device=DEV)
             * (2.0 / (k * k * Cin)) ** 0.5).to(torch.bfloat16)
        scale = torch.rand(Cout, generator=g, device=DEV) + 0.5 if affine else None
        bias = torch.randn(Cout, generator=g, device=DEV) * 0.1 if affine else None
        a = torch.rand(Cout, generator=g, device=DEV) * 0.25 if act else None
        r = (torch.randn(Fr, Ho, Ho, Cout, generator=g, device=DEV).to(torch.bfloat16)
             if res else None)
        args = (x, w, stride, pad, scale, bias, a, r)
        out = conv2d_fused(*args)
        ref = conv2d_fused_plain(*args)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out.float()).all()):
            raise RuntimeError(f"B7 {label}: non-finite output")
        torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
        err = (out.float() - ref.float()).abs().max().item()
        max_err = max(max_err, err)
        plan = conv_plan(Fr, Ho, Ho, Cin, Cout, stride, kernels.sm_count(torch.device(DEV)))
        row = dict(conv=label, F=Fr, H=H, Cin=Cin, Cout=Cout, k=k, stride=stride, pad=pad,
                   affine=affine, act=act, residual=res, per_trunk=count, max_abs_err=err,
                   kernel=plan.kernel, tile=plan[1:] if plan.kernel == "wgmma" else plan[1:3])
        if count:
            x_cl = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
            w_cl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            r_cl = r.permute(0, 3, 1, 2) if res else None

            def library():
                y = F.conv2d(x_cl, w_cl, stride=stride, padding=pad).float()
                if affine:
                    y = y * scale[:, None, None] + bias[:, None, None]
                if res:
                    y = y + r_cl.float()
                if act:
                    y = torch.clamp(y, min=0.0) + a[:, None, None] * torch.clamp(y, max=0.0)
                return y.to(torch.bfloat16)

            M, Kd = Fr * Ho * Ho, k * k * Cin
            nbytes = 2 * (x.numel() + w.numel() + M * Cout * (2 if res else 1)) + 4 * 3 * Cout
            flops = 2.0 * M * Kd * Cout
            row.update(ms=time_ms(lambda: conv2d_fused(*args), flush),
                       plain_ms=time_ms(lambda: conv2d_fused_plain(*args), flush, iters=10),
                       library_ms=time_ms(library, flush))
            row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
            row["tflop_per_s"] = flops / (row["ms"] * 1e-3) / 1e12
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                trunk[key] += count * row[key]
            trunk["nbytes"] += count * nbytes
            trunk["flops"] += count * flops
        log("B7", json.dumps(row))
        rows.append(row)
    trunk["bound_by"] = bound_ms(trunk["nbytes"], trunk["flops"])[1]
    trunk["max_abs_err"] = max_err
    trunk["tflop_per_s"] = trunk["flops"] / (trunk["ms"] * 1e-3) / 1e12
    log("B7", f"one trunk of {frames} frames (19 convs): kernel {trunk['ms']:.4f} ms "
        f"({trunk['tflop_per_s']:.1f} TFLOP/s of {trunk['flops'] / 1e9:.1f} GFLOP), plain "
        f"{trunk['plain_ms']:.4f} ms, cuDNN bf16 channels_last + torch epilogue "
        f"{trunk['library_ms']:.4f} ms, bound {trunk['bound_ms']:.4f} ms ({trunk['bound_by']}); "
        f"max_abs_err {max_err:.3g}")
    trunk["cases"] = rows
    return trunk


# --------------------------------------------------------------- serving


def counters():
    from omni_avsr_tpu_torch.ops.beam_attention import beam_decode_attention
    from omni_avsr_tpu_torch.ops.conv_block import conv2d_fused
    from omni_avsr_tpu_torch.ops.flash_attention import flash_attention
    from omni_avsr_tpu_torch.ops.flash_attention_bwd import flash_attention_bwd
    from omni_avsr_tpu_torch.ops.quant import quantized_matmul, quantized_matmul4
    from omni_avsr_tpu_torch.ops.select_topk import row_stats_chunkmax

    return {"B1": beam_decode_attention, "B2": quantized_matmul, "B3": flash_attention,
            "B4": flash_attention_bwd, "B5": row_stats_chunkmax, "B6": quantized_matmul4,
            "B7": conv2d_fused}


def reset_counts(fns) -> None:
    """Every kernel counter to 0, and B2's and B6's counts by (M, K, N)."""
    for fn in fns.values():
        fn.launches = 0
        if hasattr(fn, "shapes"):
            fn.shapes.clear()


def counts(**launches):
    """Every kernel's expected launches, 0 where not named."""
    return {key: launches.get(key, 0) for key in ("B1", "B2", "B3", "B4", "B5", "B6", "B7")}


def with_vocab(model, vocab: int):
    """`model` with the LLM at `vocab` tokens: the synthetic tokenizer's
    base vocabulary plus its 7 specials."""
    import dataclasses

    from omni_avsr_tpu_torch.data.tokenizer import synthetic_tokenizer
    from omni_avsr_tpu_torch.models.omni import OmniAVSR

    tok = synthetic_tokenizer("llama", base_vocab=vocab - 7)
    if tok.vocab_size != vocab:
        raise RuntimeError(f"synthetic vocabulary {tok.vocab_size}, not {vocab}")
    llm = dataclasses.replace(model.cfg.llm, vocab_size=vocab)
    return OmniAVSR(dataclasses.replace(model.cfg, llm=llm), tok, dtype=model.dtype)


def make_items(frames, seed: int):
    """Requests of `frames` mouth frames each (96x96 RGB) with 640 audio
    samples per frame (16 kHz, 25 fps)."""
    rng = np.random.RandomState(seed)
    return [{"audio": (rng.randn(f * 640) * 0.1).astype("float32"),
             "video": rng.randint(0, 255, (f, 96, 96, 3)).astype("uint8")} for f in frames]


SERVE_REPEATS = 5  # measured batches per configuration: the host-bound wall time varies
SERVE_REPEATS_E = 5  # (e)'s measured batches
# (e): the registry's Qwen2.5-7B with Qwen2.5's 151643-token BPE vocabulary
QWEN_E, QWEN_BASE_VOCAB = "Qwen/Qwen2.5-7B", 151643
# babble for the noisy evaluation: 10 s of seeded Gaussian noise at 16 kHz
BABBLE = (np.random.RandomState(4321).randn(10 * 16000) * 0.1).astype(np.float32)


def serve(label: str, server, items, expected, repeats: int = SERVE_REPEATS, **kw):
    """One warm batch, then `repeats` measured ones, each with every kernel
    counter set to 0 just before it and read just after; the counts must
    equal `expected(steps)` every time. Reports the median batch. `kw` goes
    to `transcribe_many` (e.g. num_beams=1)."""
    import torch

    server.transcribe_many(items, **kw)  # first use of this path's shapes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fns = counters()
    times = []
    for _ in range(repeats):
        reset_counts(fns)
        t = time.perf_counter()
        texts = server.transcribe_many(items, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        launches = {name: fn.launches for name, fn in fns.items()}
        steps = server.last_decode_steps
        want = expected(steps)
        if launches != want:
            raise RuntimeError(f"serve {label}: kernel launches {launches}, expected {want} "
                               f"for {steps} decode steps")
        if len(texts) != len(items) or not all(isinstance(s, str) for s in texts):
            raise RuntimeError(f"serve {label}: bad transcripts {texts!r}")
        if kw.get("num_beams", 2) > 1 and not all(texts):
            raise RuntimeError(f"serve {label}: an empty beam-search transcript {texts!r}")
    dt = float(np.median(times))
    audio_s = sum(len(it["audio"]) for it in items) / 16000
    row = dict(config=label, requests=len(items), audio_s=audio_s, batch_s=dt,
               batch_s_each=times, s_per_request=dt / len(items), audio_s_per_s=audio_s / dt,
               decode_steps=steps, launches=launches,
               b2_shapes=sorted(fns["B2"].shapes.items()),
               b6_shapes=sorted(fns["B6"].shapes.items()),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log("serve", json.dumps({k: v for k, v in row.items() if k not in ("b2_shapes", "b6_shapes")}))
    for i, s in enumerate(texts):
        log("serve", f"{label} request {i}: {s[:120]}")
    return row


@contextlib.contextmanager
def plain_route():
    """Route beam attention and the quantised matmuls of the LLM through
    their plain versions (the reference side of the agreement checks)."""
    import omni_avsr_tpu_torch.models.common as common_mod
    import omni_avsr_tpu_torch.models.llm as llm_mod
    from omni_avsr_tpu_torch.ops import quant
    from omni_avsr_tpu_torch.ops.beam_attention import beam_decode_attention_plain

    saved = [(llm_mod, "beam_decode_attention", beam_decode_attention_plain)]
    for mod in (common_mod, llm_mod):
        saved += [(mod, "quantized_matmul", quant.quantized_matmul_plain),
                  (mod, "quantized_matmul4", quant.quantized_matmul4_plain)]
    old = [(mod, name, getattr(mod, name)) for mod, name, _ in saved]
    try:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in old:
            setattr(mod, name, fn)


def decode_agreement(t, item, steps: int = 2) -> float:
    """Reference check on served inputs: the prefill and the first decode
    steps of the full-width LLM through the kernels (B1 and B2 or B6) and
    through their plain versions, on the same prefix, with the kernel
    route's tokens fed to both. Returns the largest relative L2 logit
    difference."""
    import torch

    import omni_avsr_tpu_torch.models.llm as llm_mod
    from omni_avsr_tpu_torch.ops.augment import audio_pipeline, video_pipeline
    from omni_avsr_tpu_torch.serve import pad_batch

    model, cfg = t.model, t.model.cfg.llm
    batch, trim = pad_batch([item], "audiovisual")
    arrays = {k: torch.as_tensor(v).to(DEV) for k, v in batch.items()}
    logits = {}
    with torch.inference_mode():
        arrays["video"] = video_pipeline(arrays["video"], arrays["video_len"])
        arrays["audio"] = audio_pipeline(arrays["audio"], arrays["audio_len"])
        prefix, valid = model.infer_prefix_masked(t.params, arrays, "audiovisual", 4, 2, trim)
        P0 = prefix.shape[1]
        Pp = -(-P0 // 16) * 16
        prefix = torch.nn.functional.pad(prefix, (0, 0, 0, Pp - P0))
        valid = torch.nn.functional.pad(valid, (0, Pp - P0))
        llm = t.params["llm"]
        layers = llm_mod.unstack_layers(llm, cfg)
        positions = torch.cumsum(valid.long(), dim=1) - 1
        last = Pp - 1 - torch.argmax(valid.flip(1).int(), dim=1)
        n_valid = valid.sum(dim=1).repeat_interleave(K)
        tokens = []
        for route in ("kernel", "plain"):
            with plain_route() if route == "plain" else contextlib.nullcontext():
                cache0 = llm_mod.KVCache.create(cfg, 1, Pp, dtype=model.dtype, device=DEV)
                lg, cache0 = llm_mod.llm_prefill_masked(llm, cfg, prefix, valid, positions, last,
                                                        cache0, "audiovisual", layers=layers)
                out = [lg]
                cache = llm_mod.AncSplitCache.from_prefill(cache0, Pp, K, N)
                anc = torch.arange(K, dtype=torch.int32, device=DEV)[None, :, None].expand(
                    1, K, N).contiguous()
                if route == "kernel":
                    tokens.append(torch.topk(lg[0], K).indices)
                for step in range(steps):
                    flat_idx = torch.roll(torch.arange(K, device=DEV), step)  # exercise ancestry
                    anc = llm_mod.update_ancestors(anc, flat_idx, step, K)
                    emb = llm_mod.embed_tokens(llm, tokens[step][:, None], model.dtype)
                    lg, cache = llm_mod.llm_decode_step_beam_anc(
                        llm, cfg, emb, step, n_valid, valid, cache, anc, K, "audiovisual",
                        layers=layers)
                    out.append(lg)
                    if route == "kernel":
                        tokens.append(lg.argmax(dim=-1))
                logits[route] = out
    worst = 0.0
    for a, b in zip(logits["kernel"], logits["plain"]):
        if not bool(torch.isfinite(a).all()):
            raise RuntimeError("non-finite logits on the kernel route")
        worst = max(worst, ((a - b).norm() / b.norm()).item())
    return worst


def whisper_layer_agreement(t) -> float:
    """One full-width Whisper layer (int8, B2 in its linears) at the 30 s
    window's T = 1500, B 3: its attention through B3 and through the plain
    version. Returns the relative L2 difference of the layer's output."""
    import torch

    import omni_avsr_tpu_torch.models.whisper as whisper_mod
    from omni_avsr_tpu_torch.models.common import layer_slice
    from omni_avsr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    cfg = t.model.cfg.whisper
    layer = layer_slice(t.params["whisper"]["layers"], 0)
    g = torch.Generator(device=DEV).manual_seed(7)
    x = torch.randn(B_SERVE, 1500, cfg.hidden_size, generator=g, device=DEV).to(torch.bfloat16)
    with torch.inference_mode():
        before = flash_attention.launches
        y = whisper_mod._encoder_layer(layer, cfg, x)
        if flash_attention.launches != before + 1:
            raise RuntimeError("the Whisper layer at T 1500 did not launch B3")
        whisper_mod.flash_attention = flash_attention_plain
        try:
            y_ref = whisper_mod._encoder_layer(layer, cfg, x)
        finally:
            whisper_mod.flash_attention = flash_attention
    if not bool(torch.isfinite(y.float()).all()):
        raise RuntimeError("non-finite Whisper layer output")
    return ((y.float() - y_ref.float()).norm() / y_ref.float().norm()).item()


def trunk_agreement(t, items) -> float:
    """The ResNet of a served batch (eval preprocessing, bf16) through B7
    (19 launches) and through B7's plain version. Returns the relative L2
    difference of the per-frame features."""
    import torch

    import omni_avsr_tpu_torch.ops.conv_block as conv_mod
    from omni_avsr_tpu_torch.models.resnet3d import resnet3d_forward
    from omni_avsr_tpu_torch.ops.augment import video_pipeline
    from omni_avsr_tpu_torch.serve import pad_batch

    batch, _ = pad_batch(items, "audiovisual")
    params = t.params["avhubert"]["video_frontend"]
    with torch.inference_mode():
        video = video_pipeline(torch.as_tensor(batch["video"]).to(DEV),
                               torch.as_tensor(batch["video_len"]).to(DEV)).to(t.model.dtype)
        before = conv_mod.conv2d_fused.launches
        y = resnet3d_forward(params, video, conv_kernel=True)
        if conv_mod.conv2d_fused.launches != before + 19:
            raise RuntimeError("the ResNet forward did not launch B7 19 times")
        kernel = conv_mod.conv2d_fused
        conv_mod.conv2d_fused = conv_mod.conv2d_fused_plain
        try:
            y_ref = resnet3d_forward(params, video, conv_kernel=True)
        finally:
            conv_mod.conv2d_fused = kernel
    if not bool(torch.isfinite(y.float()).all()):
        raise RuntimeError("non-finite ResNet features on the B7 route")
    log("reference", f"ResNet of {video.shape[0]} x {video.shape[1]} frames of "
        f"{tuple(video.shape[2:4])}: B7 19 launches")
    return ((y.float() - y_ref.float()).norm() / y_ref.float().norm()).item()


def select_agreement(t, items):
    """B5 on the logits of the first decode step of a served batch (the
    second selection of the beam loop; the first selects from the prefill's
    logits) against its plain version. Returns (shape, max_abs_err)."""
    import omni_avsr_tpu_torch.decode.decoding as dec

    captured = []
    kernel = dec.row_stats_chunkmax

    def capture(x):
        if len(captured) < 2:
            captured.append(x.clone())
        return kernel(x)

    dec.row_stats_chunkmax = capture
    try:
        t.transcribe_many(items)
    finally:
        dec.row_stats_chunkmax = kernel
    x = captured[1]
    return tuple(x.shape), b5_agreement(x)


def noisy_decode(engine, params, items, expected):
    """`OmniEngine.decode_batch`, the evaluation entry point, on a served
    batch with babble mixed at the engine's `decode_snr_target`: its kernel
    launches set to 0 just before and held to `expected(steps)` just after."""
    import torch

    from omni_avsr_tpu_torch.serve import pad_batch

    batch, trim = pad_batch(items, "audiovisual")
    batch["audio_trim_len"] = trim
    fns = counters()
    reset_counts(fns)
    t = time.perf_counter()
    texts = engine.decode_batch(params, batch, "audiovisual", 4, 2, num_beams=K, max_new=N)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = {name: fn.launches for name, fn in fns.items()}
    want = expected(engine.last_decode_steps)
    if launches != want:
        raise RuntimeError(f"noisy decode_batch: kernel launches {launches}, expected {want}")
    if len(texts) != len(items) or not all(texts):
        raise RuntimeError(f"noisy decode_batch: bad transcripts {texts!r}")
    row = dict(config=f"(b) decode_batch at SNR {engine.decode_snr_target} dB", batch_s=dt,
               decode_steps=engine.last_decode_steps, launches=launches)
    log("noisy", json.dumps(row))
    for i, text in enumerate(texts):
        log("noisy", f"request {i}: {text[:120]}")
    return row


def transcribe_one(server, item, expected):
    """One request through `Transcriber.transcribe`, its launches held to
    `expected(steps)`; returns the row with its transcript."""
    import torch

    fns = counters()
    reset_counts(fns)
    t = time.perf_counter()
    text = server.transcribe(audio=item["audio"], video=item["video"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = {name: fn.launches for name, fn in fns.items()}
    want = expected(server.last_decode_steps)
    if launches != want:
        raise RuntimeError(f"transcribe: kernel launches {launches}, expected {want}")
    if not isinstance(text, str) or not text:
        raise RuntimeError(f"transcribe: an empty transcript {text!r}")
    row = dict(request_s=dt, audio_s=len(item["audio"]) / 16000,
               decode_steps=server.last_decode_steps, launches=launches, transcript=text)
    log("transcribe", json.dumps(row))
    return row


# --------------------------------------------------------------- training


def train_batch(tok, B: int, frames: int, token_len: int, seed: int = 0):
    """`__graft_entry__._batch`'s layout: B clips of `frames` raw 96x96 RGB
    frames and 640 audio samples per frame, a padded transcript each."""
    rng = np.random.RandomState(seed)
    ids = tok.encode("hello world test")[:token_len]
    ids = ids + [tok.pad_id] * (token_len - len(ids))
    labels = [i if i != tok.pad_id else -100 for i in ids]
    S = frames * 640
    return {"tokens": np.asarray([ids] * B, np.int32), "labels": np.asarray([labels] * B, np.int32),
            "audio": (rng.randn(B, S) * 0.05).astype(np.float32),
            "audio_len": np.full((B,), S, np.int32),
            "video": rng.randint(0, 255, (B, frames, 96, 96, 3)).astype(np.uint8),
            "video_len": np.full((B,), frames, np.int32)}


def llm_lengths(model, trim: int, rate_a: int, rate_v: int, frames: int, token_len: int):
    """Each task's training sequence length (`OmniAVSR._assemble_task`)."""
    n_a, n_v = 2 + trim // rate_a, 2 + frames // rate_v
    return {m: 1 + (n_a if m != "video" else 0) + (n_v if m != "audio" else 0)
            + len(model.prompt_ids[m]) + token_len - 1 for m in model.prompt_ids}


@contextlib.contextmanager
def plain_train_route():
    """Route the trainable flash attention (B3 forward, B4 backward) and
    Whisper's B3 through their plain versions."""
    import omni_avsr_tpu_torch.models.whisper as whisper_mod
    import omni_avsr_tpu_torch.ops.flash_attention_bwd as fab
    from omni_avsr_tpu_torch.ops.flash_attention import flash_attention_plain

    swaps = [(whisper_mod, "flash_attention", flash_attention_plain),
             (fab, "flash_attention", flash_attention_plain),
             (fab, "flash_attention_bwd", fab.flash_attention_bwd_plain)]
    old = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in old:
            setattr(mod, name, fn)


def train_launches(model, flash_tasks: int, video_layers: int):
    """What one train step must launch: B3 in Whisper's layers (at T 1500,
    forward only); B3 and B4 once each in every AV-HuBERT layer that runs
    (layerdrop); in every LLM layer of a task whose sequence reaches the
    flash gate, B3 twice (the checkpoint runs the forward again in the
    backward) and B4 once; nothing else."""
    n = flash_tasks * model.cfg.llm.num_layers
    return {"B1": 0, "B2": 0, "B3": model.cfg.whisper.num_layers + video_layers + 2 * n,
            "B4": video_layers + n, "B5": 0, "B6": 0, "B7": 0}


def check_route_launches(route: str, used) -> None:
    """The kernel route launched B3 and B4; the plain route launched neither."""
    if (route == "plain") != (used["B3"] == used["B4"] == 0):
        raise RuntimeError(f"{route} route launched {used}")


def train_phase():
    """The full-width three-task train step; returns (row, launches of one
    measured step, the grad agreement row)."""
    import torch

    from omni_avsr_tpu_torch.bridge import init_params
    from omni_avsr_tpu_torch.config import TrainConfig
    from omni_avsr_tpu_torch.models.omni import flagship
    from omni_avsr_tpu_torch.ops.attention import FLASH_MIN_T_TRAIN
    from omni_avsr_tpu_torch.ops.audio_frontend import whisper_token_len
    from omni_avsr_tpu_torch.train.engine import OmniEngine
    from omni_avsr_tpu_torch.train.state import tree_leaves

    t = time.perf_counter()
    model = flagship(tiny=False)  # the 30 s Whisper window, as benchmarks/train_step.py
    params = init_params(model.cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    bank = (np.random.RandomState(1234).randn(10 * 16000) * 0.1).astype(np.float32)
    engine = OmniEngine(model, params, TrainConfig(lr=1e-3), noise_bank=bank, seed=0,
                        device=DEV)
    del params
    engine.sample_rates = lambda: (4, 2)  # both B4 sites: AV-HuBERT and the AV task's LLM
    batch = train_batch(model.tok, B_TRAIN, FRAMES_TRAIN, TOKENS_TRAIN)
    trim = -(-int(whisper_token_len(FRAMES_TRAIN * 640)) // 25) * 25
    lengths = llm_lengths(model, trim, 4, 2, FRAMES_TRAIN, TOKENS_TRAIN)
    if lengths["audiovisual"] != T_LLM_AV:
        raise RuntimeError(f"the AV task's sequence is {lengths['audiovisual']}, not {T_LLM_AV}")
    flash_tasks = [m for m, n in lengths.items() if n >= FLASH_MIN_T_TRAIN]
    n_trainable = sum(int(v.numel()) for v in tree_leaves(engine.state.trainable))
    log("train", f"engine on the card in {time.perf_counter() - t:.1f} s: {n_trainable / 1e6:.2f} M "
        f"trainable parameters (f32 masters); LLM sequence lengths {lengths}, flash in "
        f"{flash_tasks}; batch {B_TRAIN} x {FRAMES_TRAIN} frames, audio trim {trim}")
    step = lambda: engine.train_step({**batch, "audio_trim_len": trim})  # noqa: E731
    t = time.perf_counter()
    warm = float(step())
    log("train", f"warm step {time.perf_counter() - t:.2f} s, loss {warm:.4f}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fns = counters()
    times, losses, launches_each, video_layers = [], [], [], []
    for _ in range(3):
        reset_counts(fns)
        t = time.perf_counter()
        loss = float(step())  # a host sync: the step has ended on the device
        times.append(time.perf_counter() - t)
        launches = {name: fn.launches for name, fn in fns.items()}
        want = train_launches(model, len(flash_tasks), model.last_video_layers)
        if launches != want:
            raise RuntimeError(f"train step: kernel launches {launches}, expected {want} "
                               f"({model.last_video_layers} AV-HuBERT layers ran)")
        if not np.isfinite(loss):
            raise RuntimeError(f"train step: loss {loss}")
        losses.append(loss)
        launches_each.append(launches)
        video_layers.append(model.last_video_layers)
    dt = float(np.median(times))
    clip_s = B_TRAIN * FRAMES_TRAIN / 25.0
    row = dict(config=f"train B {B_TRAIN} x {FRAMES_TRAIN} frames, pad30s", batch=B_TRAIN,
               frames=FRAMES_TRAIN,
               s_per_step=dt, s_per_step_each=times, train_audio_s_per_s=clip_s / dt,
               losses=losses, warm_loss=warm, launches_each=launches_each,
               avhubert_layers_run=video_layers,
               launches=launches_each[-1], llm_lengths=lengths,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log("train", json.dumps(row))
    profile_batch("train step", step)

    # reference check: one step's loss and grads, kernel route vs plain route,
    # the same random draws (the engine's generator re-seeded on both)
    arrays, trim_len = engine._arrays({**batch, "audio_trim_len": trim})
    leaves = list(tree_leaves(engine.state.trainable))
    result = {}
    for route in ("kernel", "plain"):
        with plain_train_route() if route == "plain" else contextlib.nullcontext():
            reset_counts(fns)
            engine.generator.manual_seed(20261017)
            total, _ = engine._loss(arrays, 4, 2, trim_len, is_train=True)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
            flat = torch.cat([(torch.zeros_like(p) if g is None else g).float().reshape(-1)
                              for p, g in zip(leaves, grads)])
            check_route_launches(route, {name: fn.launches for name, fn in fns.items()})
            result[route] = (total.item(), flat)
    (lk, gk), (lp, gp) = result["kernel"], result["plain"]
    rel = ((gk - gp).norm() / gp.norm()).item()
    if not (np.isfinite(lk) and bool(torch.isfinite(gk).all())):
        raise RuntimeError("non-finite loss or grads on the kernel route")
    if rel > REL_L2_TOL or abs(lk - lp) > REL_L2_TOL * abs(lp):
        raise RuntimeError(f"train step, kernel vs plain: loss {lk} vs {lp}, grads relative L2 "
                           f"{rel:.3g}")
    agree = dict(loss_kernel=lk, loss_plain=lp, grad_rel_l2=rel, grad_norm=gp.norm().item())
    log("reference", f"one full-width train step, B3/B4 vs plain, same draws: {json.dumps(agree)} "
        f"(tol {REL_L2_TOL})")
    del engine, leaves, result, gk, gp
    torch.cuda.empty_cache()

    # the first step again on a fresh engine (same weights, seed and draws)
    # with the ResNet's raw train-mode convs through B7
    params = init_params(model.cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    engine = OmniEngine(model, params, TrainConfig(lr=1e-3), noise_bank=bank, seed=0,
                        device=DEV, conv_kernel=True)
    del params
    engine.sample_rates = lambda: (4, 2)
    reset_counts(fns)
    t = time.perf_counter()
    loss = float(engine.train_step({**batch, "audio_trim_len": trim}))
    dt = time.perf_counter() - t
    launches = {name: fn.launches for name, fn in fns.items()}
    want = {**train_launches(model, len(flash_tasks), model.last_video_layers), "B7": 19}
    if launches != want:
        raise RuntimeError(f"train step with conv_kernel: kernel launches {launches}, expected "
                           f"{want} ({model.last_video_layers} AV-HuBERT layers ran)")
    if not np.isfinite(loss):
        raise RuntimeError(f"train step with conv_kernel: loss {loss}")
    conv_row = dict(config=f"train B {B_TRAIN} x {FRAMES_TRAIN} frames, pad30s, conv_kernel",
                    first_step_s=dt, loss=loss, first_step_loss_without=warm,
                    avhubert_layers_run=model.last_video_layers, launches=launches)
    log("train", f"the first step with B7 in the ResNet: {json.dumps(conv_row)}")
    del engine
    torch.cuda.empty_cache()
    return row, agree, conv_row


def device_activities(run, least: int = 1, attempts: int = 3):
    """(name, device us) of each device activity that one call of `run`
    starts, from torch.profiler. The profiler at times drops a capture's
    device records on the H100 machine (none, or one kernel of two, while
    the wrappers' counters show the launches), so a capture of fewer than
    `least` activities is taken again, with a new call, up to `attempts`
    times; the last capture is returned whatever it holds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        acts = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(acts) >= least:
            break
        log("profile", f"the profiler recorded {len(acts)} device activities of at least "
            f"{least}: captured again")
    return acts


def profile_batch(label: str, run) -> None:
    """Where the time goes: one more call of `run` (a served batch, a train
    step) under torch.profiler, device kernels summed by name against its
    wall time (which the profiler itself lengthens)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log("profile", f"{label}: the profiler saw no device activity: device time not measured")
        return
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    log("profile", f"{label}: one batch under the profiler: {wall_us / 1e3:.1f} ms wall, device "
        f"busy {busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%, idle "
        f"{100 - 100 * busy / wall_us:.1f}%), {len(kernels)} device activities")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log("profile", f"{label}: {us / 1e3:8.2f} ms {100 * us / busy:5.1f}%  {name[:100]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from omni_avsr_tpu_torch import kernels
    from omni_avsr_tpu_torch.bridge import init_params
    from omni_avsr_tpu_torch.config import TrainConfig
    from omni_avsr_tpu_torch.data.tokenizer import synthetic_tokenizer
    from omni_avsr_tpu_torch.models.omni import flagship, registry_model
    from omni_avsr_tpu_torch.serve import Transcriber, pad_batch
    from omni_avsr_tpu_torch.train.engine import OmniEngine

    # f32 matmuls and convs in full f32 (the mel frontend); the rest is bf16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    log("device", f"{kind} | {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    sources = sorted(p.stem for p in kernels.CSRC.glob("*.cu"))
    t = time.perf_counter()
    kernels.build_all(sources)
    log("build", f"nvcc {sources} in {time.perf_counter() - t:.2f} s (one nvcc per source, "
        f"in parallel)")
    # the kernels on tensor cores: wgmma (B3, B2/B6, B4, B7) and mma.sync (B1, B7)
    for name in ("flash_attention", "quant_matmul", "flash_attention_bwd", "beam_attention",
                 "conv_block"):
        for row in kernels.ptxas_report(name):
            log("ptxas", f"{name}: {json.dumps(row)}")

    # the three serving configurations' models and requests
    model_a = flagship(tiny=False, whisper_input_mode="pad30s")
    model_b = flagship(tiny=False, whisper_input_mode="bucket")
    frames_a, frames_b = (300, 280, 260), (160, 160, 160)
    items_a, items_b = make_items(frames_a, seed=1), make_items(frames_b, seed=0)
    batch_a, trim_a = pad_batch(items_a, "audiovisual")
    P_a = model_a.prefix_slots("audiovisual", 4, 2, trim_a, batch_a["video"].shape[1])
    batch_b, trim_b = pad_batch(items_b, "audiovisual")
    if model_b.prefix_slots("audiovisual", 4, 2, trim_b, batch_b["video"].shape[1]) != P_BUCKET:
        raise RuntimeError("the bucketed requests' prefix is not the B1 check's P")
    # (e): Qwen2.5-7B from the registry, Qwen2.5's BPE vocabulary plus the specials
    model_e = registry_model(QWEN_E, synthetic_tokenizer("qwen", base_vocab=QWEN_BASE_VOCAB),
                             whisper_input_mode="bucket")
    llm_e = model_e.cfg.llm
    heads_e = (llm_e.num_heads, llm_e.num_kv_heads, llm_e.head_dim)
    P_e = model_e.prefix_slots("audiovisual", 4, 2, trim_b, batch_b["video"].shape[1])

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    b1 = check_b1(flush, P_BUCKET)
    b1_a = check_b1(flush, P_a, batches=(B_SERVE,))  # the prefix configuration (a) serves
    b1_greedy = check_b1(flush, P_BUCKET, batches=(1, B_SERVE), K=1)  # greedy decoding
    b1_k65 = check_b1(flush, P_BUCKET, batches=(1, B_SERVE), K=65)  # past one 64-bit mask word
    b1_k128 = check_b1(flush, P_BUCKET, batches=(1, B_SERVE), K=128)
    b1_e = check_b1(flush, P_e, batches=(B_SERVE,), heads=heads_e)  # (e): G 7, D 128
    b3, b3_rows = check_b3(flush)
    b4_rows = check_b4(flush)
    vocab = model_a.cfg.llm.vocab_size
    b2 = check_qmm(flush, int4=False, vocab=vocab)
    b6 = check_qmm(flush, int4=True, vocab=vocab)
    b5 = check_b5(flush)
    b7 = check_b7(flush)
    torch.cuda.empty_cache()

    t = time.perf_counter()
    params = init_params(model_a.cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    server_a = Transcriber(model_a, params, quantize="int8", device="cuda")
    server_b = Transcriber(model_b, params, quantize="int8", device="cuda")
    server_c = Transcriber(model_b, params, quantize="int4", device="cuda")
    # the evaluation entry point: babble at 0 dB SNR, decoded on (b)'s tree
    engine_noisy = OmniEngine(model_b, params, TrainConfig(), noise_bank=BABBLE,
                              decode_snr_target=0.0, seed=0, device="cuda")
    del params
    torch.cuda.synchronize()
    n_params = sum(int(v.numel()) for v in _leaves(server_a.params))
    log("model", f"flagship full width on the card, three serving trees (int8 30 s window, int8 "
        f"bucketed, int4 bucketed): {n_params / 1e9:.3f} B parameters in the int8 tree, "
        f"{time.perf_counter() - t:.1f} s")

    layers_llm = model_a.cfg.llm.num_layers
    tower_b2 = 6 * (model_a.cfg.whisper.num_layers + model_a.cfg.avhubert.encoder_layers)
    llm_mats = 4 * layers_llm + 1  # q|k|v, o, gate|up, down per layer, and the lm_head
    tower_b3 = model_a.cfg.whisper.num_layers + model_a.cfg.avhubert.encoder_layers
    # B2 (or B6) runs once per LLM matrix in the prefill and in every decode step
    rows = {
        "a": serve("(a) pad30s int8", server_a, items_a, lambda s: counts(
            B1=layers_llm * s, B2=tower_b2 + llm_mats * (1 + s), B3=tower_b3)),
        "b": serve("(b) bucket int8", server_b, items_b, lambda s: counts(
            B1=layers_llm * s, B2=tower_b2 + llm_mats * (1 + s))),
        "c": serve("(c) bucket int4", server_c, items_b, lambda s: counts(
            B1=layers_llm * s, B2=tower_b2, B6=llm_mats * (1 + s))),
        "greedy": serve("(b) bucket int8 greedy", server_b, items_b, lambda s: counts(
            B1=layers_llm * s, B2=tower_b2 + llm_mats * (1 + s)), repeats=3, num_beams=1),
    }

    # more beams than one 64-bit live-beam mask word of B1: two requests
    rows["b65"] = serve("(b) bucket int8 65 beams", server_b, items_b[:2], lambda s: counts(
        B1=layers_llm * s, B2=tower_b2 + llm_mats * (1 + s)), repeats=1, num_beams=65)
    rows["noisy"] = noisy_decode(engine_noisy, server_b.params, items_b, lambda s: counts(
        B1=layers_llm * s, B2=tower_b2 + llm_mats * (1 + s)))
    del engine_noisy

    for label, server in (("int8 (B1, B2)", server_b), ("int4 (B1, B6)", server_c)):
        rel = decode_agreement(server, items_b[0])
        if rel > REL_L2_TOL:
            raise RuntimeError(f"{label} logits: kernel vs plain relative L2 {rel:.3g}")
        log("reference", f"{label}: prefill + 2 decode steps at full width, kernel vs plain "
            f"route: relative L2 logit difference {rel:.3g} (tol {REL_L2_TOL})")
    rel = whisper_layer_agreement(server_a)
    if rel > REL_L2_TOL:
        raise RuntimeError(f"Whisper layer at T 1500: B3 vs plain relative L2 {rel:.3g}")
    log("reference", f"one full-width Whisper layer at T 1500, B 3: B3 vs plain attention: "
        f"relative L2 difference {rel:.3g} (tol {REL_L2_TOL})")

    # B2 at every shape of one (a) and one (b) batch, B6 at every shape of
    # one (c) batch, summed by stage
    llm_dims = (model_a.cfg.llm.hidden_size, model_a.cfg.llm.intermediate_size)
    b2_batches = {}
    for key in ("a", "b"):
        sums, shape_rows = qmm_per_batch(flush, rows[key]["config"], rows[key]["b2_shapes"],
                                         vocab, llm_dims)
        b2_batches[key] = dict(config=rows[key]["config"], by_stage=sums, shapes=shape_rows)
    sums, shape_rows = qmm_per_batch(flush, rows["c"]["config"], rows["c"]["b6_shapes"], vocab,
                                     llm_dims, bits=4)
    b6_batch = dict(config=rows["c"]["config"], by_stage=sums, shapes=shape_rows)

    profile_batch("(a) pad30s int8", lambda: server_a.transcribe_many(items_a))
    profile_batch("(b) bucket int8", lambda: server_b.transcribe_many(items_b))
    profile_batch("(c) bucket int4", lambda: server_c.transcribe_many(items_b))
    del server_a, server_b, server_c
    torch.cuda.empty_cache()

    # (d): (b) with the LLM at Llama-3's base vocabulary (128256, a multiple
    # of 128, so the selection kernel takes it) and both opt-in kernel routes
    t = time.perf_counter()
    model_d = with_vocab(model_b, VOCAB_D)
    params = init_params(model_d.cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    server_d = Transcriber(model_d, params, quantize="int8", device="cuda", select_kernel=True,
                           conv_kernel=True)
    del params
    torch.cuda.synchronize()
    log("model", f"(d): the flagship with a {VOCAB_D}-token LLM vocabulary, int8, select_kernel "
        f"and conv_kernel on, in {time.perf_counter() - t:.1f} s")
    rows["d"] = serve("(d) bucket int8 select conv", server_d, items_b, lambda s: counts(
        B1=layers_llm * s, B2=tower_b2 + llm_mats * (1 + s), B5=s, B7=19))
    rel = trunk_agreement(server_d, items_b)
    if rel > REL_L2_TOL:
        raise RuntimeError(f"ResNet at full width: B7 vs plain relative L2 {rel:.3g}")
    log("reference", f"the ResNet of (d)'s batch, B7 vs plain: relative L2 difference {rel:.3g} "
        f"(tol {REL_L2_TOL})")
    shape, err = select_agreement(server_d, items_b)
    log("reference", f"B5 on the logits {shape} of (d)'s first decode step: maxima bit-equal, "
        f"normaliser within rtol 1e-5, max_abs_err {err:.3g}")
    b5["real_logits_max_abs_err"] = err
    b7["trunk_rel_l2"] = rel
    profile_batch("(d) bucket int8 select conv", lambda: server_d.transcribe_many(items_b))
    del server_d
    torch.cuda.empty_cache()

    # (e): Qwen2.5-7B at full width and depth, random weights from a seed, int8
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(model_e.cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_bf16 = sum(int(v.numel()) for v in _leaves(params))
    server_e = Transcriber(model_e, params, quantize="int8", device="cuda")
    del params
    torch.cuda.synchronize()
    log("model", f"(e) {QWEN_E}: {llm_e.num_layers} layers, hidden {llm_e.hidden_size}, "
        f"{llm_e.num_heads}/{llm_e.num_kv_heads} heads at D {llm_e.head_dim}, FFN "
        f"{llm_e.intermediate_size}, vocabulary {llm_e.vocab_size}, untied head; "
        f"{n_bf16 / 1e9:.3f} B parameters at init (bf16), int8 serving tree in "
        f"{time.perf_counter() - t:.1f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.1f} "
        f"GiB while it was built")
    layers_e = llm_e.num_layers
    mats_e = 4 * layers_e + 1
    expect_e = lambda s: counts(B1=layers_e * s, B2=tower_b2 + mats_e * (1 + s))  # noqa: E731
    rows["e"] = serve("(e) Qwen2.5-7B bucket int8", server_e, items_b, expect_e,
                      repeats=SERVE_REPEATS_E)
    rows["e transcribe"] = transcribe_one(server_e, items_b[0], expect_e)
    rel = decode_agreement(server_e, items_b[0])
    if rel > REL_L2_TOL:
        raise RuntimeError(f"(e) logits: kernel vs plain relative L2 {rel:.3g}")
    log("reference", f"(e) {QWEN_E} int8 (B1 at G {heads_e[0] // heads_e[1]}, D {heads_e[2]}; "
        f"B2): prefill + 2 decode steps, kernel vs plain route: relative L2 logit difference "
        f"{rel:.3g} (tol {REL_L2_TOL})")
    rows["e"]["decode_rel_l2"] = rel
    sums, shape_rows = qmm_per_batch(flush, rows["e"]["config"], rows["e"]["b2_shapes"],
                                     llm_e.vocab_size, (llm_e.hidden_size,
                                                        llm_e.intermediate_size))
    steps_e = rows["e"]["decode_steps"]
    per_step = {k: sums["decode"][k] / steps_e
                for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log("B2", f"(e) one decode step ({layers_e} x qkv, o, gateup, down + lm_head, M 45), from "
        f"the batch's {steps_e} steps: {json.dumps(per_step)}")
    b2_batches["e"] = dict(config=rows["e"]["config"], by_stage=sums, shapes=shape_rows,
                           decode_step=per_step)
    profile_batch("(e) Qwen2.5-7B bucket int8", lambda: server_e.transcribe_many(items_b))
    del server_e, flush
    torch.cuda.empty_cache()

    rows["train"], train_agree, rows["train conv"] = train_phase()

    def entry(key, name, source, replaces, row, config, shape):
        """The kernel's line: its launches in the configuration whose main
        kernel it is, and in each configuration."""
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": rows[config]["launches"][key], "max_abs_err": row["max_abs_err"],
                "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"], "shape": shape,
                "launches_by_config": {c: r["launches"][key] for c, r in rows.items()}}

    print(json.dumps({"kernels": [
        {**entry("B1", "beam_decode_attention", "omni_avsr_tpu_torch/csrc/beam_attention.cu",
                 "omni_avsr_tpu/ops/beam_attention.py:51", b1, "b",
                 "per launch: B 3 x 15 beams, P 176, step 17; cases: the timed shapes (K 15 "
                 "at P 176 and 400, K 1, K 65, K 128, and (e)'s Qwen2.5-7B: Hq 28 / Hkv 4, D "
                 "128)"),
         "cases": [b1, b1_a, b1_greedy, b1_k65, b1_k128, b1_e]},
        {**entry("B2", "quantized_matmul", "omni_avsr_tpu_torch/csrc/quant_matmul.cu",
                 "omni_avsr_tpu/ops/quant.py:54", b2, "b",
                 "one decode step, M 45: 16 x (qkv, o, gateup, down) + lm_head; tower_ms and "
                 "prefill_ms: one (b) batch's tower and prefill launches, summed; per_batch: "
                 "(a), (b) and (e) by stage, qwen7b_decode_step: (e)'s per step"),
         "tower_ms": b2_batches["b"]["by_stage"]["tower"]["ms"],
         "prefill_ms": b2_batches["b"]["by_stage"]["prefill"]["ms"],
         "per_batch": {k: v["by_stage"] for k, v in b2_batches.items()},
         "qwen7b_decode_step": b2_batches["e"]["decode_step"],
         "tower_fc1_m4500": b2["tower"]},
        {**entry("B3", "flash_attention", "omni_avsr_tpu_torch/csrc/flash_attention.cu",
                 "omni_avsr_tpu/ops/flash_attention.py:58", b3, "a",
                 "per launch: Whisper 30 s window, B 3, 16 heads, T = S = 1500, D 64; cases: "
                 "every timed shape, library_kernels naming SDPA's backend"),
         "cases": b3_rows},
        {**entry("B4", "flash_attention_bwd", "omni_avsr_tpu_torch/csrc/flash_attention_bwd.cu",
                 "omni_avsr_tpu/ops/flash_attention_bwd.py:44", b4_rows[1], "train",
                 f"per launch (dq + dk/dv kernels): LLM causal, B 4, Hq 32 / Hkv 8, "
                 f"T = S = {T_LLM_AV}, D 64; launches per train step"),
         "cases": b4_rows, "replaces_also": "omni_avsr_tpu/ops/flash_attention_bwd.py:89",
         "train_grad_agreement": train_agree},
        {**entry("B5", "row_stats_chunkmax", "omni_avsr_tpu_torch/csrc/select_topk.cu",
                 "omni_avsr_tpu/ops/select_topk.py:52", b5, "d",
                 f"per launch: {B_SERVE} x 15 beams = 45 rows, V {VOCAB_D}; library_ms is "
                 f"torch.logsumexp, which gives the normaliser only"),
         "timed": b5},
        {**entry("B6", "quantized_matmul4", "omni_avsr_tpu_torch/csrc/quant_matmul.cu",
                 "omni_avsr_tpu/ops/quant.py:156", b6, "c",
                 "one decode step, M 45: 16 x (qkv, o, gateup, down) + lm_head; per_batch: one "
                 "(c) batch's prefill and decode launches, summed"),
         "per_batch": b6_batch["by_stage"], "per_batch_shapes": b6_batch["shapes"]},
        {**entry("B7", "conv2d_fused", "omni_avsr_tpu_torch/csrc/conv_block.cu",
                 "omni_avsr_tpu/ops/conv_block.py:70", b7, "d",
                 "one ResNet trunk of 480 frames (19 convs, summed); library_ms is cuDNN's "
                 "bf16 conv in channels_last with the epilogue as torch ops"),
         "cases": b7["cases"], "trunk_rel_l2": b7["trunk_rel_l2"],
         "tflop_per_s": b7["tflop_per_s"]},
    ]}), flush=True)
    log("done", f"{time.perf_counter() - T0:.1f} s in all")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    sys.exit(main())
