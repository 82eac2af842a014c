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
     key lengths and dropout 0.1, the LLM's causal GQA shape; a CUDA graph
     of one call must hold its two kernels and nothing else), B2 and
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
     For each, one warm batch and 3 measured ones (the median reported); every kernel counter is set to 0 just before each
     measured batch, read just after, and held to the count the path must
     give. Then (g): `cli/serve_http.py::serve` in front of (a)'s
     Transcriber, eight client threads posting at once (4 audiovisual
     requests of 160 frames, 3 audio-only ones of 6.4 s, and one naming
     "audiovisual" without video, a 400): an audiovisual batch of 4 and an
     audio batch of 3, each batch's launches held to its count, each text
     equal to `transcribe_many` of the batch called directly;
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
  6. where the device time goes, one profiled batch per configuration
     (the device's records only, summed from the profiler's raw records);
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
     train-mode convs, 19 launches), its loss beside the first step's;
     then (h) on (t)'s batch: the Llama-MTSK flagship (one prompt, a
     modality-agnostic LoRA) through `OmniEngine.single_train_step` on
     audio, video and audiovisual (the mean over every rate combo), one warm
     and two measured steps each, and one `single_eval_step`; then the
     task-specific flagship with `fused_task_forward=True` at rates (4, 2),
     one warm and two measured `train_step`s (B4 at B 12 x T 347 in the
     stacked backbone), and in eval mode its per-task losses and one
     step's grads against the unfused route (bf16, tol 2e-2); every
     step's B3 and B4 launches held to the count its rate combos give;
  8. (f), corpus eval + train at full width, as the CLIs run it: a corpus
     written by `data/synthetic.py::generate_corpus` (8 train, 2 val and 6
     test clips of 150-160 frames, seed 0) and read by `DataModule`;
     `test_batches(3)` of each task at its first rates through
     `OmniEngine.decode_batch` on the int8 tree `eval_omni
     --quantize-decode int8` builds (the flagship, 30 s window, beam 15, 32
     new tokens), WER by `WerAccumulator`, each batch's B1, B2 and B3
     launches held to the count the path must give; then two epochs of
     `train_batches` through `OmniEngine.train_step` with validation and
     `save_checkpoint` after each, every step's B3 and B4 launches held to
     the count its rates and lengths give, then `restore_checkpoint` (the
     restored state must equal the saved one) and `average_last_n` (the
     mean of the two checkpoints), each timed;
  8a. the reference numerics profile (`OMNI_PROFILE=reference` as
     arguments): (j) (a)'s three requests on the flagship in bf16 weights
     on the reorder route with grid selection (`attn_route="xla",
     select_mode="grid"`; B3 48 and nothing else), held against the
     kernel route (B1) on the same tree, the device time of the reorder
     gather, the grid top-k and one layer's three-block attention per
     step, then one (b) batch with `no_repeat_ngram_size=2` on the kernel
     route (no output repeats a bigram); the threefry draws of
     `utils/prng.py` at AV-HuBERT's dropout shape, card against CPU bit
     for bit; (k) (t)'s batch through `OmniEngine(prng="threefry",
     bn_stats="twopass")` at remat "off", "dots" and "full" from the same
     masters and key (the losses within 1e-5 relative, a second "dots"
     run bit-equal), each step's launches held to its policy's count;
     (f)'s two train epochs run through `utils/prefetch.py::device_prefetch`
     and their losses must be bit-equal to a synchronous upload's;
  8b. the AV-HuBERT family at full width (AV-HuBERT Large without LoRA,
     random weights from a seed, (t)'s 4 clips of 320 frames with the
     stacked filterbanks of their waveforms): (l) `train_avhubert_s2s`'s
     step (`S2STrainer`) with the seq2seq decoder of `S2SDecoderConfig()`
     (remat "dots": B3 48, B4 24 a step), with the CTC head (remat "off":
     B3 24, B4 24) and with a frozen encoder (B3 24, B4 0, the encoder
     bit-equal after it), 64-token targets; one step's grads through
     B3/B4, through their plain versions and in f32; `eval_avhubert_s2s`'s
     bf16 decode, greedy and beam 15, 64 steps (B3 24 a batch) and its first
     two steps' logits on both routes; (m) `pretrain_avhubert`'s step at its
     defaults (B3 48, B4 24) with the same three-way grad check, the encoder
     saved in the port's checkpoint format, `cluster_units`' layer-12 dump
     of one clip from it (B3 12) and a k-means of 100 over its frames;
  4a. right after (e), whose int8 tree is now built layer by layer from
     its bf16 tree on the card (its build peak printed beside the 43.2 GiB
     that the whole-tree build peaked at on an H100): (n) the registry's Qwen2.5-32B at full width and depth (64
     layers, hidden 5120, FFN 27648, 40/8 heads at D 128, untied head),
     its int8 tree drawn layer by layer (`bridge.init_serving_params`; the
     build's time and peak printed, the peak held under 70 GiB), serving
     (b)'s three requests (B1 64 a step, B2 once per tower and LLM matrix
     of the prefill and of every step), its prefill and two decode steps
     held kernel against plain route and B2 at every shape of a batch; then
     Qwen2.5-14B in packed int4 the same way, one `transcribe` request
     through B6, B6 at its shapes; (o) the flagship with 8 experts a layer
     (`moe_experts=8`, 12.9 GB of bf16 experts), unquantised: (b)'s
     requests with balanced routing (the routing kernel once per layer and
     forward, 16 x (1 + steps) a batch), the kernel's assignments on the
     first batch's prefill layer 0 bit-equal to its plain loop, the prefill
     and two decode steps kernel against plain route; one batch with top-1
     routing (no routing kernel); two train steps on (t)'s batch (the
     routing kernel 96 a step: 3 tasks x 16 layers, forward and the "dots"
     recompute), a train step's layer-0 assignments bit-equal, and one
     step's grads kernel against plain; the routing kernel timed at the
     prefill's, a decode step's and the train step's rows;
  4b. after (p): (q) the last modules at full width: `llm_loss` forward
     and backward on Llama-3.2-1B at Llama-3's 128256-token vocabulary
     (random weights from a seed, every LoRA leaf drawn), B 4 x T 512 bf16
     embeddings with -100 on a prefix of each row's labels: B3 32 (16
     layers and the "dots" recompute) and B4 16 asserted, the loss and the
     grads of the embeddings and the audiovisual adapter held against the
     plain route (relative L2 2e-2), s per forward + backward and peak
     memory; `llm_logits` with an explicit padding mask (no launch), held
     against the CPU in f32 on two rows' first 128 positions;
     `lightweight_conv` and `dynamic_conv` at lightconv_wmt_en_de_big's
     width (C 1024, 16 heads; K 3, 7, 15, 31, causal and centred; B 4 x T
     1024 bf16) against float64 on the CPU, ms a call; `checkify_step`
     around (t)'s first train step (the unwrapped step's loss bit for bit,
     the same launches, `count_nonfinite` of the trainables 0), a step fed
     a NaN and a backward dividing by zero on the card, both raising;
  4c. after (q): (r), (u), (v) on gloo ranks that share the card; (r)
     sequence parallelism on gloo ranks that share the
     card (`parallel/launch.py::RankPool`, one process a rank, each with
     its engine on the card; NCCL takes one rank a device): a probe of
     gloo's and the port's collectives on card tensors, then one train step
     of (t)'s batch on (o)'s MoE flagship (balanced routing, full width
     and depth) at tp 2 with SP and without it on two ranks, and on the
     flagship with the registry's Qwen2.5-0.5B (14 / 2 heads: the attention
     replicates, the MLP runs four-way) at tp 4 with SP on four ranks;
     each run's loss and whole trainable grads (the routing replayed from
     the meshless run, the calls whose own choice differs counted) against
     the meshless step in this process (loss 1e-3 relative, grads 2e-2
     relative L2), each rank's B3, B4 and routing launches equal to the
     meshless step's, each rank's peak GiB and s/step (the ranks share the
     SMs and stage collectives through host memory), each run's state after
     the step (masters and AdamW moments, 2e-2 relative L2); in the same
     pools (u) `Transcriber(mesh=...)` through `transcribe_many` at tp 2
     and tp 4 on the flagship with (d)'s 128256-token vocabulary and
     `select_kernel` (B5 per vocabulary shard where the kernel takes it)
     and Qwen2.5-7B at tp 2 (the ranks building in turns), each rank's
     B1 / B2 / B5 launches held to its shard's path, the logits of a
     prefill and two decode steps on the meshless run's prefix and tokens
     within 2e-2 relative L2 of the meshless Transcriber's; and (v) the
     flagship's train step at dp 2 with and without FSDP and the MoE
     flagship's at ep 2, as (r) holds its cases; gloo's isend / recv of a
     card tensor probed in a pool of its own, and pp 2 run only if it
     passes;
  9. the CLIs as a user runs them, as subprocesses on the card, three at a
     time after the first:
     `serve_http --synthetic` (/healthz, one audio request, then stopped),
     `eval_omni --synthetic 2 --num-beams 2 --max-dec-tokens 4` with
     `--quantize-decode int8` and with `int4`, `train_omni --synthetic 4
     --max-epochs 2`, `train_llama_avsr --synthetic 6 --max-epochs 1
     --modality audio`, `eval_llama_avsr --synthetic 4 --modality audio
     --quantize-decode int8` and `verify_parity --synthetic 2 --modes
     bf16,int8,int4`, `train_omni` and `eval_omni` with `--moe-experts 4`
     (the routing kernel launched): exit 0 (verify_parity 1, all 8 settings measured:
     random weights fail BASELINE.md), the result keys, the checkpoints and
     `model_avg_4`; B2 in the int8 runs, B6 in the int4 ones, B1 in none
     (the tiny head size 16 takes the reorder route); verify_parity under
     its default `--profile reference` must report all eight pins held,
     and the int8 eval_omni run passes `--compilation-cache-dir`; then the
     AV-HuBERT family's (`OMNI_REMAT=off`): `train_avhubert_s2s --synthetic
     4` with the s2s head on video and the CTC head on audiovisual with a
     frozen encoder, `eval_avhubert_s2s` on a synthetic fairseq checkpoint
     and dictionary (beam 3), `pretrain_avhubert --synthetic 4` for 2
     steps, and `cluster_units` on its corpus with `--features mfcc` and
     with `--features avhubert` on its checkpoint; and `gen_subword` (bpe,
     char, word) on (f)'s transcripts, its dictionary loaded in
     `FairseqDictionary` (bpe: with the `BPEEncoder`'s ids), the token-block
     utilities on the transcripts' BPE sizes in every mode against their
     Python references.
Then a `kernels` JSON line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failure raises and exits non-zero; without a CUDA device the script
exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


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
        (f"llm causal T {T_LLM_AV} B12 GQA 32/8 lse (fused train)", 3 * B_TRAIN, T_LLM_AV,
         T_LLM_AV, 32, 8, 64, dict(causal=True, return_lse=True), True),
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
    """B4 against its plain version at the training phase's shapes (the
    fused three-task step's (3B, T) backbone among them), each timed
    against the backward of scaled_dot_product_attention (a yardstick; the
    port never calls it) and the bound; at AV-HuBERT's dropout shape, rows
    2-3 run as a dp rank's (`dropout_row0=2`) through B3 and B4, bit-equal
    to the whole batch's rows. Returns the rows."""
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
        (f"llm causal fused T {T_LLM_AV} B 12 GQA 32/8", 3 * B_TRAIN, T_LLM_AV, 32, 8, True, None,
         0.0),
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
        if rate:  # a dp rank's rows 2-3: B3 and B4 hash each row's mask by its global index
            mine = dict(kw, kv_lengths=kv[2:].clone(), dropout_row0=2)  # 16-byte aligned
            po, plse = flash_attention(q[2:], k[2:], v[2:], return_lse=True, **mine)
            pg = flash_attention_bwd(q[2:], k[2:], v[2:], po, do[2:], plse, **mine)
            if not (torch.equal(po, o[2:]) and torch.equal(plse, lse[2 * Hq:])
                    and all(torch.equal(a, b[2:]) for a, b in zip(pg, got))):
                raise RuntimeError(f"B4 {name}: rows 2-3 with dropout_row0=2 differ from the "
                                   f"whole batch's")
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
                   dp_rows_bit_equal=True if rate else None,
                   ms=time_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, **kw), flush),
                   plain_ms=time_ms(lambda: flash_attention_bwd_plain(q, k, v, o, do, lse, **kw),
                                    flush, iters=10),
                   library_ms=time_ms(lambda: torch.autograd.grad(
                       out, (qh, kh, vh), doh, retain_graph=True), flush))
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
        row["bytes_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        row["operations_bound_ms"] = flops / BF16_FLOPS * 1e3
        # the wrapper allocates and launches its two kernels, and runs no other
        # op: a CUDA graph of one call holds those two kernel nodes alone
        census = graph_census(lambda: flash_attention_bwd(q, k, v, o, do, lse, **kw))
        families = sorted((re.search(r"flash_bwd_(dq|dkv)_kernel", n) or [n])[0]
                          for n in census)
        if families != ["flash_bwd_dkv_kernel", "flash_bwd_dq_kernel"]:
            raise RuntimeError(f"B4 {name}: one call put the device work {census} in a graph, "
                               f"not the two kernels alone")
        # three warm calls under the profiler, for each kernel's device time; the
        # profiler may drop records, but a name it does record must be one of the two
        acts = device_activities(lambda: [flash_attention_bwd(q, k, v, o, do, lse, **kw)
                                          for _ in range(3)], least=6)
        by_name: dict = {}
        for n, us in acts:
            by_name.setdefault((re.search(r"(\w+)<", n) or re.search(r"(\w+)\(", n)).group(1),
                               []).append(us)
        if not set(by_name) <= {"flash_bwd_dkv_kernel", "flash_bwd_dq_kernel"} or len(acts) > 6:
            raise RuntimeError(f"B4 {name}: three calls ran the device work {acts}, not the "
                               f"two kernels alone")
        row["graph_census"] = census
        row["device_kernels_us"] = ({n: sum(v) / len(v) for n, v in by_name.items()}
                                    if len(acts) == 6 else "not measured: the profiler "
                                    f"recorded {len(acts)} of the 6 device activities")
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


def b2_stage(M: int, Kd: int, Nd: int, vocab: int, llm_dims, decode_m: int = B_SERVE * K) -> str:
    """Which stage of a served batch runs B2 or B6 at (M, K, N): the decode
    steps (M = `decode_m`, 3 requests x 15 beams by default, with their
    lm_head), the LLM prefill (the LLM's widths, and the lm_head of the last
    prefix token) or the towers."""
    if M == decode_m:
        return "decode"
    if Nd == vocab or Kd in llm_dims:
        return "prefill"
    return "tower"


def qmm_per_batch(flush, label: str, shapes, vocab: int, llm_dims, bits: int = 8,
                  decode_m: int = B_SERVE * K):
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
        stage = b2_stage(M, Kd, Nd, vocab, llm_dims, decode_m)
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
    from omni_avsr_tpu_torch.ops.moe_route import balanced_assignment
    from omni_avsr_tpu_torch.ops.quant import quantized_matmul, quantized_matmul4
    from omni_avsr_tpu_torch.ops.select_topk import row_stats_chunkmax

    return {"B1": beam_decode_attention, "B2": quantized_matmul, "B3": flash_attention,
            "B4": flash_attention_bwd, "B5": row_stats_chunkmax, "B6": quantized_matmul4,
            "B7": conv2d_fused, "MOE": balanced_assignment}


def reset_counts(fns) -> None:
    """Every kernel counter to 0, and B2's and B6's counts by (M, K, N)."""
    for fn in fns.values():
        fn.launches = 0
        if hasattr(fn, "shapes"):
            fn.shapes.clear()


def counts(**launches):
    """Every kernel's expected launches, 0 where not named."""
    return {key: launches.get(key, 0) for key in ("B1", "B2", "B3", "B4", "B5", "B6", "B7", "MOE")}


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


SERVE_REPEATS = 3  # measured batches per configuration: the host-bound wall time varies
SERVE_REPEATS_E = 3  # (e)'s measured batches
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


def routes_bit_equal(store) -> tuple:
    """Every recorded routing call (`moe_routes`): the kernel's assignments
    against the plain loop on a host copy of the same router logits.
    Raises on any difference; returns (calls, rows) checked."""
    import torch

    from omni_avsr_tpu_torch.ops.moe_route import balanced_assignment_plain

    bad = []
    for i, (scores, capacity, got) in enumerate(store):
        want = balanced_assignment_plain(scores.cpu(), capacity)
        if not torch.equal(got.cpu(), want):
            bad.append((i, int((got.cpu() != want).sum()), len(want)))
    if bad:
        raise RuntimeError(f"routing kernel vs plain loop: (call, rows differing, rows) {bad[:8]} "
                           f"in {len(bad)} of {len(store)} calls")
    return len(store), sum(len(out) for _, _, out in store)


@contextlib.contextmanager
def moe_routes(store: list, route: str):
    """The balanced routing of an MoE decoder: on the kernel route each
    call's (scores, capacity, assignments) recorded and, once the route has
    run, every call held bit-equal to the plain loop on the same logits
    (`routes_bit_equal`); on the plain route the assignments replayed, call
    for call. Routing is a discrete choice: a bf16-level difference in the
    router logits (B1 or B3/B4 against their plain versions) flips
    near-tied greedy choices, and a flipped token then runs another expert,
    so without the replay the routes' logits part by far more than the
    kernels' numerics (0.379 relative L2 on (o) on an NVIDIA H100 80GB
    HBM3). The plain loop also runs on the plain route's own logits, to
    count the choices that those differences flip. No effect on a model
    without MoE layers."""
    import omni_avsr_tpu_torch.models.moe as moe_mod
    from omni_avsr_tpu_torch.ops.moe_route import balanced_assignment_plain

    fn = moe_mod.balanced_assignment
    replayed = []

    def record(scores, capacity):
        out = fn(scores, capacity)
        store.append((scores.detach().clone(), capacity, out.clone()))
        return out

    def replay(scores, capacity):
        out = store[len(replayed)][2]
        if out.shape[0] != scores.shape[0]:
            raise RuntimeError(f"routing replay: {scores.shape[0]} rows, recorded {out.shape[0]}")
        own = balanced_assignment_plain(scores.detach().cpu(), capacity)
        replayed.append((int((own != out.cpu()).sum()), len(own)))
        return out

    moe_mod.balanced_assignment = replay if route == "plain" else record
    try:
        yield
    finally:
        moe_mod.balanced_assignment = fn
    if route == "kernel" and store:
        calls, rows = routes_bit_equal(store)
        log("MOE", f"kernel route: {calls} routing calls, {rows} rows, every assignment "
            f"bit-equal to the plain loop on the same logits")
    if replayed:
        if len(replayed) != len(store):
            raise RuntimeError(f"routing replay: {len(replayed)} calls, recorded {len(store)}")
        log("MOE", f"plain route: {len(replayed)} routing calls replayed from the kernel route; "
            f"its own routing would choose another expert for {sum(f for f, _ in replayed)} of "
            f"{sum(n for _, n in replayed)} rows")


@contextlib.contextmanager
def plain_route():
    """Route beam attention and the quantised matmuls of the LLM through
    their plain versions (the reference side of the agreement checks; an
    MoE decoder's routing is replayed by `moe_routes`)."""
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


def served_prefix(t, item):
    """One request's prefix through t's towers and projectors, and its valid
    slots, padded as its served batch pads them (to a multiple of 16 slots),
    under t's parallel scope."""
    import torch

    from omni_avsr_tpu_torch.ops.augment import audio_pipeline, video_pipeline
    from omni_avsr_tpu_torch.parallel.collectives import scope
    from omni_avsr_tpu_torch.serve import pad_batch

    batch, trim = pad_batch([item], "audiovisual")
    arrays = {k: torch.as_tensor(v).to(t.device) for k, v in batch.items()}
    with torch.inference_mode(), scope(t.par):
        arrays["video"] = video_pipeline(arrays["video"], arrays["video_len"])
        arrays["audio"] = audio_pipeline(arrays["audio"], arrays["audio_len"])
        prefix, valid = t.model.infer_prefix_masked(t.params, arrays, "audiovisual", 4, 2, trim)
    pad = -(-prefix.shape[1] // 16) * 16 - prefix.shape[1]
    return (torch.nn.functional.pad(prefix, (0, 0, 0, pad)),
            torch.nn.functional.pad(valid, (0, pad)))


def llm_steps(t, prefix, valid, tokens=None, steps: int = 2):
    """The prefill and `steps` decode steps at K beams of t's LLM (B2 or B6,
    and B1) over one request's prefix, under t's parallel scope: each
    step's logits over the whole vocabulary (a tensor-parallel head's
    slices gathered), and the tokens fed. The steps feed `tokens` (the
    prefill's K, then each step's K), or with None their own: the
    prefill's top K, then each beam's argmax."""
    import torch

    import omni_avsr_tpu_torch.models.llm as llm_mod
    from omni_avsr_tpu_torch.decode.decoding import full_logits
    from omni_avsr_tpu_torch.parallel.collectives import scope

    model, cfg, llm = t.model, t.model.cfg.llm, t.params["llm"]
    dev, Pp = prefix.device, prefix.shape[1]
    own = tokens is None
    tokens = [] if own else list(tokens)
    with torch.inference_mode(), scope(t.par):
        layers = llm_mod.unstack_layers(llm, cfg)
        positions = torch.cumsum(valid.long(), dim=1) - 1
        last = Pp - 1 - torch.argmax(valid.flip(1).int(), dim=1)
        n_valid = valid.sum(dim=1).repeat_interleave(K)
        cache0 = llm_mod.KVCache.create(cfg, 1, Pp, dtype=model.dtype, device=dev)
        lg, cache0 = llm_mod.llm_prefill_masked(llm, cfg, prefix, valid, positions, last, cache0,
                                                "audiovisual", layers=layers)
        out = [full_logits(lg, cfg.vocab_size)]
        cache = llm_mod.AncSplitCache.from_prefill(cache0, Pp, K, N)
        anc = torch.arange(K, dtype=torch.int32, device=dev)[None, :, None].expand(
            1, K, N).contiguous()
        if own:
            tokens.append(torch.topk(out[0][0], K).indices)
        for step in range(steps):
            flat_idx = torch.roll(torch.arange(K, device=dev), step)  # exercise ancestry
            anc = llm_mod.update_ancestors(anc, flat_idx, step, K)
            emb = llm_mod.embed_tokens(llm, tokens[step][:, None], model.dtype)
            lg, cache = llm_mod.llm_decode_step_beam_anc(
                llm, cfg, emb, step, n_valid, valid, cache, anc, K, "audiovisual",
                layers=layers)
            out.append(full_logits(lg, cfg.vocab_size))
            if own:
                tokens.append(out[-1].argmax(dim=-1))
    return out, tokens


def worst_rel_l2(got, want) -> float:
    """The largest relative L2 difference of `got`'s tensors from `want`'s,
    pair by pair; raises on a non-finite value in `got`."""
    worst = 0.0
    for a, b in zip(got, want):
        if not bool(a.isfinite().all()):
            raise RuntimeError("non-finite logits")
        worst = max(worst, ((a.float() - b.float()).norm() / b.float().norm()).item())
    return worst


def decode_agreement(t, item, steps: int = 2) -> float:
    """Reference check on served inputs: the prefill and the first decode
    steps of the full-width LLM through the kernels (B1 and B2 or B6) and
    through their plain versions, on the same prefix, with the kernel
    route's tokens (and an MoE decoder's routing, `moe_routes`) fed to
    both. Returns the largest relative L2 logit difference."""
    prefix, valid = served_prefix(t, item)
    routes = []
    with moe_routes(routes, "kernel"):
        kernel, tokens = llm_steps(t, prefix, valid, steps=steps)
    with plain_route(), moe_routes(routes, "plain"):
        plain, _ = llm_steps(t, prefix, valid, tokens, steps)
    return worst_rel_l2(kernel, plain)


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
    row.update(b2_shapes=sorted(fns["B2"].shapes.items()),
               b6_shapes=sorted(fns["B6"].shapes.items()))
    return row


# ------------------------------ (n): Qwen2.5-32B and -14B, drawn layer by layer

QWEN_N, QWEN_N4 = "Qwen/Qwen2.5-32B", "Qwen/Qwen2.5-14B"
BUILD_PEAK_LIMIT_GIB = 70.0  # the card's 80 GB less room to serve


def build_streamed(name: str, mode: str):
    """A registry model (Whisper-medium, AV-HuBERT Large and the named LLM at
    Qwen2.5's vocabulary, bucketed window) and its Transcriber on a `mode`
    tree drawn layer by layer (`bridge.init_serving_params`): never the
    whole bf16 LLM on the card. Returns (model, Transcriber, build row);
    the build's peak must stay under BUILD_PEAK_LIMIT_GIB."""
    import torch

    from omni_avsr_tpu_torch.bridge import init_serving_params
    from omni_avsr_tpu_torch.data.tokenizer import synthetic_tokenizer
    from omni_avsr_tpu_torch.models.omni import registry_model
    from omni_avsr_tpu_torch.serve import Transcriber

    model = registry_model(name, synthetic_tokenizer("qwen", base_vocab=QWEN_BASE_VOCAB),
                           whisper_input_mode="bucket")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2**30
    t = time.perf_counter()
    tree = init_serving_params(model.cfg, torch.Generator(device=DEV).manual_seed(0), mode, DEV)
    server = Transcriber(model, tree, device=DEV)
    del tree
    torch.cuda.synchronize()
    llm = model.cfg.llm
    row = dict(model=name, mode=mode, layers=llm.num_layers, hidden=llm.hidden_size,
               ffn=llm.intermediate_size, heads=[llm.num_heads, llm.num_kv_heads, llm.head_dim],
               vocab=llm.vocab_size, build_s=time.perf_counter() - t,
               build_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               tree_gib=torch.cuda.memory_allocated() / 2**30 - before,
               allocated_before_gib=before)
    log("model", f"{name} at full width and depth, {mode} tree drawn layer by layer: "
        f"{json.dumps(row)}")
    if row["build_peak_gib"] >= BUILD_PEAK_LIMIT_GIB:
        raise RuntimeError(f"{name} {mode}: build peak {row['build_peak_gib']:.1f} GiB")
    return model, server, row


def per_step(sums, steps: int) -> dict:
    return {k: sums["decode"][k] / steps for k in ("ms", "plain_ms", "library_ms", "bound_ms")}


def big_qwen_phase(items, tower_b2: int, flush):
    """(n): Qwen2.5-32B int8 serving (b)'s three requests (beam 15, 32 new
    tokens; B1 once per layer and decode step, B2 once per tower matrix and
    per LLM matrix of the prefill and of every step), its prefill and two
    decode steps held kernel against plain route, and B2 at every shape of
    one batch; then Qwen2.5-14B int4: one request through B6, and B6 at
    every shape of it. Returns (rows, B2's and B6's per-step sums)."""
    import torch

    rows = {}
    model, server, build = build_streamed(QWEN_N, "int8")
    llm = model.cfg.llm
    L, mats = llm.num_layers, 4 * llm.num_layers + 1
    expect = lambda s: counts(B1=L * s, B2=tower_b2 + mats * (1 + s))  # noqa: E731
    rows["n"] = serve("(n) Qwen2.5-32B bucket int8", server, items, expect)
    rows["n"]["build"] = build
    rel = decode_agreement(server, items[0])
    if rel > REL_L2_TOL:
        raise RuntimeError(f"(n) logits: kernel vs plain relative L2 {rel:.3g}")
    rows["n"]["decode_rel_l2"] = rel
    log("reference", f"(n) {QWEN_N} int8: prefill + 2 decode steps, kernel vs plain route: "
        f"relative L2 logit difference {rel:.3g} (tol {REL_L2_TOL})")
    profile_batch("(n) Qwen2.5-32B bucket int8", lambda: server.transcribe_many(items))
    del server
    torch.cuda.empty_cache()
    sums, shape_rows = qmm_per_batch(flush, rows["n"]["config"], rows["n"]["b2_shapes"],
                                     llm.vocab_size, (llm.hidden_size, llm.intermediate_size))
    b2_step = per_step(sums, rows["n"]["decode_steps"])
    log("B2", f"(n) one decode step ({L} x qkv, o, gateup, down + lm_head, M 45): "
        f"{json.dumps(b2_step)}")
    rows["n"]["b2_decode_step"] = b2_step

    model, server, build = build_streamed(QWEN_N4, "int4")
    llm = model.cfg.llm
    L, mats = llm.num_layers, 4 * llm.num_layers + 1
    row = transcribe_one(server, items[0], lambda s: counts(B1=L * s, B2=tower_b2,
                                                             B6=mats * (1 + s)))
    row.update(config="(n) Qwen2.5-14B bucket int4, one request", build=build)
    del server
    torch.cuda.empty_cache()
    # one request decodes its 15 beams: M 15 is the decode steps' shape
    sums, _ = qmm_per_batch(flush, row["config"], row["b6_shapes"], llm.vocab_size,
                            (llm.hidden_size, llm.intermediate_size), bits=4, decode_m=K)
    b6_step = per_step(sums, row["decode_steps"])
    log("B6", f"(n) Qwen2.5-14B, one decode step of one request ({L} x qkv, o, gateup, down + "
        f"lm_head, M {K}): {json.dumps(b6_step)}")
    row["b6_decode_step"] = b6_step
    rows["n 14b"] = row
    return rows, b2_step, b6_step


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
    Whisper's B3 through their plain versions (an MoE decoder's routing is
    replayed by `moe_routes`)."""
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


def train_launches(model, flash_tasks: int, video_layers: int, remat: str = "dots",
                   llm_layers=None):
    """What one train step must launch: B3 in Whisper's layers (at T 1500,
    forward only); in every AV-HuBERT layer that runs (layerdrop) and in
    every LLM layer of a task whose sequence reaches the flash gate, B4
    once and B3 once in the forward and, under the remat policies "dots"
    (the engine's default) and "full", once more where the backward
    recomputes the layer; in an MoE decoder with balanced routing, the
    routing kernel in every layer of the three tasks' forwards and
    recomputes; nothing else. `llm_layers`: the LLM layers this rank runs
    (a pipeline stage's), else all."""
    llm = model.cfg.llm
    layers = llm.num_layers if llm_layers is None else llm_layers
    n = flash_tasks * layers
    again = 1 if remat == "off" else 2
    moe = llm.moe_experts and llm.moe_routing == "balanced"
    return counts(B3=model.cfg.whisper.num_layers + again * (video_layers + n),
                  B4=video_layers + n, MOE=again * 3 * layers if moe else 0)


def check_route_launches(route: str, used) -> None:
    """The kernel route launched B3 and B4; the plain route launched neither
    (nor the MoE routing)."""
    if (route == "plain") != (used["B3"] == used["B4"] == used["MOE"] == 0):
        raise RuntimeError(f"{route} route launched {used}")


def step_grad_agreement(engine, batch, trim: int, fns, label: str) -> dict:
    """Reference check of a train step: its loss and trainable grads through
    the kernels and through their plain versions (`plain_train_route`),
    with the same random draws (the engine's generator re-seeded on both)
    and an MoE decoder's routing replayed (`moe_routes`): the grads within
    relative L2 REL_L2_TOL, the loss too."""
    import torch

    from omni_avsr_tpu_torch.train.state import tree_leaves

    arrays, trim_len = engine._arrays({**batch, "audio_trim_len": trim})
    leaves = list(tree_leaves(engine.state.trainable))
    result, routes = {}, []
    for route in ("kernel", "plain"):
        with plain_train_route() if route == "plain" else contextlib.nullcontext(), \
                moe_routes(routes, route):
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
        raise RuntimeError(f"{label}: non-finite loss or grads on the kernel route")
    if rel > REL_L2_TOL or abs(lk - lp) > REL_L2_TOL * abs(lp):
        raise RuntimeError(f"{label}, kernel vs plain: loss {lk} vs {lp}, grads relative L2 "
                           f"{rel:.3g}")
    agree = dict(loss_kernel=lk, loss_plain=lp, grad_rel_l2=rel, grad_norm=gp.norm().item())
    log("reference", f"{label} vs plain, same draws: {json.dumps(agree)} (tol {REL_L2_TOL})")
    return agree


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

    agree = step_grad_agreement(engine, batch, trim, fns, "one full-width train step, B3/B4")
    del engine
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


# ------------------------------------------------------- (p): parallelism

P_SHARD_MODELS = (  # (label, Hq, Hkv, D, hidden, FFN, layers, vocab for B2 / B5)
    ("Llama-3.2-1B", 32, 8, 64, 2048, 8192, 16, 128256),
    ("Qwen2.5-7B", 28, 4, 128, 3584, 18944, 28, 152064),
)


def _b2_leaf(K: int, N: int, seed: int, layers: int = 1):
    """A JAX-layout int8 leaf {"w" (layers, K, N), "s" (layers, N)} of
    seeded codes (`layers=0`: no layer axis)."""
    import torch

    lead = (layers,) if layers else ()
    g = torch.Generator(device=DEV).manual_seed(seed)
    w = torch.randint(-127, 128, (*lead, K, N), generator=g, device=DEV, dtype=torch.int32)
    s = torch.rand(*lead, N, generator=g, device=DEV) * 0.01 + 1e-3
    return {"w": w.to(torch.int8), "s": s}


def _b2_bound(M: int, K: int, N: int, out_bytes: int) -> float:
    return bound_ms(K * N + 4 * N + 2 * M * K + out_bytes * M * N, 2.0 * M * N * K)[0]


def shard_b2(flush, tp: int, H: int, F: int, Hq: int, Hkv: int, D: int, vocab: int,
             layers: int, M: int) -> dict:
    """One tp rank's B2 launches of a decode step: its shard of a one-layer
    int8 serving tree cut by `serve.py::shard_serving_tree`, as
    `Transcriber(mesh=...)` cuts it (q|k|v, gate|up and the lm_head by
    columns, o and down by rows, fused and laid out for the card per
    rank), each product held against the unsharded tree's (the same
    function at tp 1): the ranks' columns concatenated, the row-split
    partials summed as the all-reduce sums them."""
    import torch

    from omni_avsr_tpu_torch.ops.quant import layer_slice, quantized_matmul
    from omni_avsr_tpu_torch.serve import shard_serving_tree

    x = torch.randn(M, max(H, F), device=DEV).to(torch.bfloat16)
    q_dim, kv_dim = Hq * D, Hkv * D
    tree = {"llm": {"layers": {
        "attn": {"q": _b2_leaf(H, q_dim, 1), "k": _b2_leaf(H, kv_dim, 2),
                 "v": _b2_leaf(H, kv_dim, 3), "o": _b2_leaf(q_dim, H, 4)},
        "mlp": {"gate": _b2_leaf(H, F, 5), "up": _b2_leaf(H, F, 6), "down": _b2_leaf(F, H, 7)}},
        "lm_head": _b2_leaf(H, vocab, 8, layers=0)}}

    def leaves(r, n):  # {product: (input, card leaf)} of rank r of n
        local, blocks = shard_serving_tree(tree, {"tp": n}, True, coords={"tp": r})
        if n > 1 and blocks != {"llm.attn", "llm.mlp", "llm.lm_head"}:
            raise RuntimeError(f"B2 tp {n}: blocks {sorted(blocks)} run replicated")
        layer = layer_slice(local["llm"]["layers"], 0)
        qs, fs = slice(r * q_dim // n, (r + 1) * q_dim // n), slice(r * F // n, (r + 1) * F // n)
        return {"qkv": (x[:, :H], layer["attn"]["qkv"]), "o": (x[:, qs], layer["attn"]["o"]),
                "gateup": (x[:, :H], layer["mlp"]["gateup"]),
                "down": (x[:, fs], layer["mlp"]["down"]),
                "lm_head": (x[:, :H], local["llm"]["lm_head"])}

    def mm(xm, leaf):
        return quantized_matmul(xm.contiguous(), leaf, out_dtype=torch.float32)

    full = {k: mm(*v) for k, v in leaves(0, 1).items()}
    rank_leaves = [leaves(r, tp) for r in range(tp)]
    parts = {k: [mm(*lv[k]) for lv in rank_leaves] for k in full}
    fl, ql, kl = F // tp, q_dim // tp, kv_dim // tp

    def regroup(pieces, bounds):  # each rank's [a_r | b_r | ...] -> [a | b | ...]
        return torch.cat([torch.cat([p[:, c0:c1] for p in pieces], 1) for c0, c1 in bounds], 1)

    got = {"o": sum(parts["o"]), "down": sum(parts["down"]),
           "lm_head": torch.cat(parts["lm_head"], 1),
           "gateup": regroup(parts["gateup"], [(0, fl), (fl, 2 * fl)]),
           "qkv": regroup(parts["qkv"], [(0, ql), (ql, ql + kl), (ql + kl, ql + 2 * kl)])}
    errs = {}
    for k in full:
        rel = ((got[k] - full[k]).norm() / full[k].norm()).item()
        errs[k] = rel
        if rel > 1e-5:
            raise RuntimeError(f"B2 tp {tp} {k}: ranks vs unsharded relative L2 {rel:.3g}")
    # rank 0's launches timed (every rank's shapes are the same)
    row = {"max_rel_l2": max(errs.values())}
    step_ms = step_bound = 0.0
    for k, (xm, leaf) in rank_leaves[0].items():
        xm = xm.contiguous()
        Kd, Nd = xm.shape[1], leaf["s"].shape[-1]
        out_b = 4 if k == "lm_head" else 2
        odt = torch.float32 if k == "lm_head" else torch.bfloat16
        ms = time_ms(lambda: quantized_matmul(xm, leaf, out_dtype=odt), flush, iters=20)
        bnd = _b2_bound(M, Kd, Nd, out_b)
        reps = 1 if k == "lm_head" else layers
        row[k] = dict(K=Kd, N=Nd, ms=ms, bound_ms=bnd)
        step_ms += reps * ms
        step_bound += reps * bnd
    row.update(decode_step_ms=step_ms, decode_step_bound_ms=step_bound)
    return row


def shard_b1(flush, tp: int, Hq: int, Hkv: int, D: int, layers: int) -> dict:
    """One tp rank's B1 launch at its heads (Hq/tp, Hkv/tp), every rank's
    output held against the unsharded kernel's heads."""
    import torch

    from omni_avsr_tpu_torch.ops.beam_attention import beam_decode_attention

    step = 17
    inp = b1_inputs(B_SERVE, P_BUCKET, step, seed=tp * 100 + Hq, heads=(Hq, Hkv, D))
    full = beam_decode_attention(**inp, step=step, num_beams=K)
    hq, hkv = Hq // tp, Hkv // tp
    rank_inp = []
    for r in range(tp):
        qs, ks = slice(r * hq, (r + 1) * hq), slice(r * hkv, (r + 1) * hkv)
        ri = dict(inp, q=inp["q"][:, :, qs].contiguous(), pk=inp["pk"][:, ks].contiguous(),
                  pv=inp["pv"][:, ks].contiguous(), gk=inp["gk"][:, ks].contiguous(),
                  gv=inp["gv"][:, ks].contiguous(), k_cur=inp["k_cur"][:, ks].contiguous(),
                  v_cur=inp["v_cur"][:, ks].contiguous())
        rank_inp.append(ri)
    got = torch.cat([beam_decode_attention(**ri, step=step, num_beams=K) for ri in rank_inp], 2)
    torch.testing.assert_close(got.float(), full.float(), **BF16_TOL)
    err = (got.float() - full.float()).abs().max().item()
    ri = rank_inp[0]
    ms = time_ms(lambda: beam_decode_attention(**ri, step=step, num_beams=K), flush, iters=20)
    bnd = b1_bound_ms(ri, step)
    return dict(Hq=hq, Hkv=hkv, D=D, max_abs_err=err, ms=ms, bound_ms=bnd,
                decode_step_ms=layers * ms, decode_step_bound_ms=layers * bnd)


def shard_b5(flush, tp: int, V: int) -> dict:
    """One tp rank's B5 launch and chunked top-2K on V/tp of 45 rows of
    logits (`decode/decoding.py::select_shard`, a shard that is no multiple
    of 128 padded with -inf columns), every rank's merged by
    `merge_select_shards`, the merge `_fused_select_sharded` runs after its
    all-gathers: the maxima and the candidates bit-equal to the unsharded
    selection's, the normaliser within rtol 1e-5."""
    import torch

    from omni_avsr_tpu_torch.decode.decoding import merge_select_shards, select_shard
    from omni_avsr_tpu_torch.ops.select_topk import CHUNK, row_stats_chunkmax

    Vs = V // tp
    R, k2 = B_SERVE * K, 2 * K
    g = torch.Generator(device=DEV).manual_seed(V + tp)
    x = (torch.randn(B_SERVE, K, V, generator=g, device=DEV) * 4)
    mx, se, vals, idx = select_shard(x, k2, True)
    shards = [select_shard(x[..., r * Vs:(r + 1) * Vs].contiguous(), k2, True, r * Vs)
              for r in range(tp)]
    m_mx, m_lse, m_vals, m_idx = merge_select_shards(
        *(torch.stack([sh[i] for sh in shards], -1) for i in (0, 1)),
        *(torch.cat([sh[i] for sh in shards], -1) for i in (2, 3)), k2)
    if not (torch.equal(m_mx[..., 0], mx) and torch.equal(m_vals, vals)
            and torch.equal(m_idx, idx)):
        raise RuntimeError(f"B5 tp {tp} at V {V}: the merged maxima or candidates differ")
    torch.testing.assert_close(m_lse[..., 0], torch.log(se), rtol=1e-5, atol=0)
    Vp = -(-Vs // CHUNK) * CHUNK  # the padded shard B5 reads
    xs = torch.nn.functional.pad(x[..., :Vs].reshape(R, Vs), (0, Vp - Vs), value=float("-inf"))
    ms = time_ms(lambda: row_stats_chunkmax(xs), flush, iters=20)
    nbytes = 4 * (R * Vp + R * (Vp // 128) + 2 * R)
    return dict(V=V, Vs=Vs, padded_Vs=Vp, ms=ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                lse_max_abs_err=(m_lse[..., 0] - torch.log(se)).abs().max().item())


@contextlib.contextmanager
def one_rank_world(work: Path):
    """This process as rank 0 of a world of one, NCCL on the card, through
    `maybe_initialize_distributed` and a file store under `work`; the
    environment and the process group are restored after."""
    import shutil

    import torch.distributed as dist

    from omni_avsr_tpu_torch.parallel.distributed import maybe_initialize_distributed

    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               OMNI_DIST_INIT=f"file://{work / 'store'}")
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        if not maybe_initialize_distributed(device=DEV, timeout_s=300):
            raise RuntimeError("maybe_initialize_distributed did not start the group")
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def nccl_kernels(run) -> list:
    """The NCCL kernels the profiler sees in `run` (empty when it records no
    device activity), from its raw device records (`profile_batch`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    return sorted({e.name() for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA
                   and "nccl" in e.name().lower() and e.duration_ns() > 0})


def parallel_phase(flush, items_b) -> dict:
    """(p): the distributed code path at world size 1 under NCCL at full
    width (an FSDP train step and a `Transcriber(mesh=...)` batch, each
    held against the meshless one), then the per-rank B1, B2 and B5
    launches of a tp mesh at tp 2 and 4, at the shard shapes of
    Llama-3.2-1B and Qwen2.5-7B, each held against the unsharded kernel.
    NCCL allows one rank per device: this card is one rank, so the shard
    launches are what one rank of a tp mesh runs, not a multi-card run."""
    import argparse

    import torch

    from omni_avsr_tpu_torch.bridge import init_params
    from omni_avsr_tpu_torch.cli.common import setup_parallelism
    from omni_avsr_tpu_torch.config import TrainConfig
    from omni_avsr_tpu_torch.models.omni import flagship
    from omni_avsr_tpu_torch.ops.attention import FLASH_MIN_T_TRAIN
    from omni_avsr_tpu_torch.ops.audio_frontend import whisper_token_len
    from omni_avsr_tpu_torch.serve import Transcriber
    from omni_avsr_tpu_torch.train.engine import OmniEngine
    from omni_avsr_tpu_torch.train.state import tree_leaves

    rows = {}
    fns = counters()
    t0 = time.perf_counter()
    with one_rank_world(Path(__file__).resolve().parent / "build" / "chip_smoke_rdzv"):
        args = argparse.Namespace(mesh_tp=1, mesh_pp=1, mesh_ep=1, fsdp=True,
                                  sequence_parallel=False, pp_microbatches=4)
        mesh, feed, plan = setup_parallelism(args, torch.device(DEV))
        log("parallel", f"NCCL world of 1 through maybe_initialize_distributed (file store); "
            f"mesh {dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))}, plan {plan}")
        model = flagship(tiny=False)
        params = init_params(model.cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
        bank = (np.random.RandomState(1234).randn(10 * 16000) * 0.1).astype(np.float32)
        engines = {name: OmniEngine(model, params, TrainConfig(lr=1e-3), noise_bank=bank, seed=0,
                                    device=DEV, **kw)
                   for name, kw in (("meshless", {}), ("fsdp", dict(mesh=mesh, fsdp=True)))}
        del params
        batch = train_batch(model.tok, B_TRAIN, FRAMES_TRAIN, TOKENS_TRAIN)
        trim = -(-int(whisper_token_len(FRAMES_TRAIN * 640)) // 25) * 25
        lengths = llm_lengths(model, trim, 4, 2, FRAMES_TRAIN, TOKENS_TRAIN)
        flash_tasks = [m for m, n in lengths.items() if n >= FLASH_MIN_T_TRAIN]
        out = {}
        for name, engine in engines.items():
            engine.sample_rates = lambda: (4, 2)
            b = {**batch, "audio_trim_len": trim}
            reset_counts(fns)
            loss = float(engine.train_step(feed(b) if name == "fsdp" else b))
            launches = {k: fn.launches for k, fn in fns.items()}
            want = train_launches(model, len(flash_tasks), model.last_video_layers)
            if launches != want:
                raise RuntimeError(f"(p) {name} step: kernel launches {launches}, expected "
                                   f"{want}")
            flat = torch.cat([x.detach().float().reshape(-1)
                              for x in tree_leaves(engine.full_state().trainable)])
            out[name] = (loss, flat, launches)
        (l0, f0, n0), (l1, f1, n1) = out["meshless"], out["fsdp"]
        rel = ((f1 - f0).norm() / f0.norm()).item()
        if not np.isfinite(l1):
            raise RuntimeError(f"(p) FSDP step: loss {l1}")
        if abs(l1 - l0) > 1e-6 * abs(l0) or rel > 1e-6:
            raise RuntimeError(f"(p) FSDP step vs meshless: loss {l1} vs {l0}, trainable "
                               f"relative L2 {rel:.3g}")
        engine = engines["fsdp"]
        nccl = nccl_kernels(lambda: engine.train_step(
            feed({**batch, "audio_trim_len": trim})))
        rows["p train"] = dict(config="(p) FSDP train step, NCCL world 1", loss=l1,
                               loss_meshless=l0, bit_equal_loss=l1 == l0,
                               trainable_rel_l2=rel, trainable_bit_equal=bool(torch.equal(f0, f1)),
                               launches=n1, nccl_kernels=nccl or "not measured")
        log("parallel", json.dumps(rows["p train"]))
        del engines, engine
        torch.cuda.empty_cache()

        model_b = flagship(tiny=False, whisper_input_mode="bucket")
        params = init_params(model_b.cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
        plain = Transcriber(model_b, params, quantize="int8", device=DEV)
        meshed = Transcriber(model_b, params, quantize="int8", device=DEV, mesh=mesh)
        del params
        want = plain.transcribe_many(items_b)
        reset_counts(fns)
        got = meshed.transcribe_many(items_b)
        launches = {k: fn.launches for k, fn in fns.items()}
        s = meshed.last_decode_steps
        layers_llm = model_b.cfg.llm.num_layers
        tower_b2 = 6 * (model_b.cfg.whisper.num_layers + model_b.cfg.avhubert.encoder_layers)
        expect = counts(B1=layers_llm * s, B2=tower_b2 + (4 * layers_llm + 1) * (1 + s))
        if got != want or launches != expect:
            raise RuntimeError(f"(p) Transcriber(mesh): {got} vs {want}; launches {launches}, "
                               f"expected {expect}")
        ids_equal = bool(torch.equal(meshed.decode_ids(*_padded(items_b), 15),
                                     plain.decode_ids(*_padded(items_b), 15)))
        rows["p serve"] = dict(config="(p) Transcriber(mesh) int8 (b), NCCL world 1",
                               token_identical=ids_equal, decode_steps=s, launches=launches,
                               tp_blocks=sorted(meshed.par.tp_blocks))
        if not ids_equal:
            raise RuntimeError("(p) Transcriber(mesh): ids differ from the meshless ones")
        log("parallel", json.dumps(rows["p serve"]))
        del plain, meshed
        torch.cuda.empty_cache()
    log("parallel", f"world-1 NCCL path in {time.perf_counter() - t0:.1f} s")

    shards = {}
    reset_counts(fns)  # every launch of the shard checks and their timing
    for label, Hq, Hkv, D, H, F, layers, vocab in P_SHARD_MODELS:
        for tp in (1, 2, 4):
            key = f"{label} tp {tp}"
            shards[key] = dict(
                B1=shard_b1(flush, tp, Hq, Hkv, D, layers),
                B2=shard_b2(flush, tp, H, F, Hq, Hkv, D, vocab, layers, B_SERVE * K),
                B5=shard_b5(flush, tp, vocab))
            log("parallel", f"per-rank kernels, {key} (one rank's decode step): "
                f"{json.dumps(shards[key])}")
    rows["p shards"] = dict(config="(p) per-rank shard kernels, checks and timing",
                            shards=shards, launches={k: fn.launches for k, fn in fns.items()})
    log("parallel", f"(p) in {time.perf_counter() - t0:.1f} s")
    return rows


# ------------------------------------------------- (q): the last modules

Q_B, Q_T = 4, 512  # llm_loss's batch: B 4 x T 512 bf16 embeddings, over the flash gate of 256
Q_PREFIX = (200, 250, 300, 350)  # each row's labels are -100 before these positions
Q_LENGTHS = (512, 100, 300, 64)  # the explicit padding mask's valid keys, a row
Q_CPU_ROWS, Q_CPU_T = (1, 3), 128  # the masked forward's CPU reference: padding inside
LC_B, LC_T, LC_C, LC_H = 4, 1024, 1024, 16  # fairseq's lightconv_wmt_en_de_big: C 1024, H 16
LC_KERNELS = (3, 7, 15, 31)


def q_llm_loss(flush) -> dict:
    """`llm_loss` (forward and backward) on the full-width Llama-3.2-1B at
    Llama-3's vocabulary, random weights from a seed (every LoRA leaf
    drawn), B 4 x T 512: the kernel route (B3 in every layer's forward and
    again in the "dots" recompute, B4 in every layer's backward, counts
    asserted) against the plain route (`plain_train_route`) for the loss
    and the grads of the embeddings and the task's adapter; then
    `llm_logits` with an explicit padding mask, which launches nothing, held
    against the same call on the CPU in f32."""
    import torch

    from omni_avsr_tpu_torch.bridge import init_llm
    from omni_avsr_tpu_torch.models.llm import llm_logits, llm_loss
    from omni_avsr_tpu_torch.models.omni import flagship

    t0 = time.perf_counter()
    cfg = with_vocab(flagship(tiny=False), VOCAB_D).cfg.llm
    gen = torch.Generator(device=DEV).manual_seed(20)
    params = init_llm(cfg, gen, DEV)
    for pair in params["layers"]["lora"].values():  # the downs start at zero
        for name in ("down_q", "down_v"):
            pair[name]["w"].normal_(0.0, 0.02, generator=gen)
    task = params["layers"]["lora"]["audiovisual"]
    leaves = [task[n]["w"].requires_grad_(True) for n in ("down_q", "up_q", "down_v", "up_v")]
    rng = np.random.RandomState(20)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (Q_B, Q_T))).to(DEV)
    embeds = params["embed"]["w"][ids].detach().requires_grad_(True)  # (B, T, 2048) bf16
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (Q_B, Q_T))).to(DEV)
    for r, p in enumerate(Q_PREFIX):
        labels[r, :p] = -100

    def fwd_bwd():
        loss = llm_loss(params, cfg, embeds, labels, modality="audiovisual")
        return loss, torch.autograd.grad(loss, [embeds] + leaves)

    L = cfg.num_layers
    fns = counters()
    result = {}
    for route in ("kernel", "plain"):
        with plain_train_route() if route == "plain" else contextlib.nullcontext():
            reset_counts(fns)
            loss, grads = fwd_bwd()
            torch.cuda.synchronize()
            used = {n: fn.launches for n, fn in fns.items()}
        want = counts(B3=2 * L, B4=L) if route == "kernel" else counts()
        if used != want:
            raise RuntimeError(f"(q) llm_loss, {route} route: launches {used}, expected {want}")
        flat = torch.cat([g.float().reshape(-1) for g in grads])
        if not (bool(torch.isfinite(loss)) and bool(torch.isfinite(flat).all())):
            raise RuntimeError(f"(q) llm_loss, {route} route: non-finite loss or grads")
        result[route] = (float(loss.detach()), flat, used)
    (lk, gk, used), (lp, gp, _) = result["kernel"], result["plain"]
    grad_rel = float((gk - gp).norm() / gp.norm())
    if grad_rel > REL_L2_TOL or abs(lk - lp) > REL_L2_TOL * abs(lp):
        raise RuntimeError(f"(q) llm_loss kernel vs plain: loss {lk} vs {lp}, grads relative L2 "
                           f"{grad_rel:.3g}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t = time.perf_counter()
        fwd_bwd()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated() / 2**30
    profile_batch("(q) llm_loss forward + backward", fwd_bwd)
    row = dict(config=f"(q) llm_loss Llama-3.2-1B, B {Q_B} x T {Q_T}, V {cfg.vocab_size}, bf16, "
               f"remat dots", loss_kernel=lk, loss_plain=lp, grad_rel_l2=grad_rel,
               grad_norm=float(gp.norm()), s_per_fwd_bwd=float(np.median(times)),
               s_each=times, peak_gib=peak, card=card(), launches=used)
    log("q", json.dumps(row))

    # an explicit padding mask: the plain attention in every layer, no B3
    lengths = torch.tensor(Q_LENGTHS, device=DEV)
    valid = torch.arange(Q_T, device=DEV)[None] < lengths[:, None]
    mask = torch.ones(Q_T, Q_T, dtype=torch.bool, device=DEV).tril()[None, None] \
        & valid[:, None, None, :]
    reset_counts(fns)
    with torch.no_grad():
        t = time.perf_counter()
        logits = llm_logits(params, cfg, embeds.detach(), mask=mask, modality="audiovisual")
        torch.cuda.synchronize()
        masked_s = time.perf_counter() - t
    used_masked = {n: fn.launches for n, fn in fns.items()}
    if used_masked != counts():
        raise RuntimeError(f"(q) llm_logits with a mask launched {used_masked}")
    rows_ = list(Q_CPU_ROWS)
    cpu = _cpu_f32(params)
    with torch.no_grad():
        t = time.perf_counter()
        ref = llm_logits(cpu, cfg, embeds.detach()[rows_, :Q_CPU_T].float().cpu(),
                         mask=mask[rows_][:, :, :Q_CPU_T, :Q_CPU_T].cpu(),
                         modality="audiovisual", remat="off")
        cpu_s = time.perf_counter() - t
    rel = rel_l2(logits[rows_, :Q_CPU_T], ref)
    if rel > REL_L2_TOL or not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"(q) masked llm_logits, card vs CPU: relative L2 {rel:.3g}")
    masked = dict(config=f"(q) llm_logits with a padding mask {list(Q_LENGTHS)}, B {Q_B} x T "
                  f"{Q_T}", s=masked_s, cpu_rows=rows_, cpu_positions=Q_CPU_T,
                  rel_l2_vs_cpu_f32=rel, cpu_s=cpu_s, launches=used_masked)
    log("q", json.dumps(masked))
    del params, cpu, grads, logits
    torch.cuda.empty_cache()
    log("q", f"llm_loss and masked llm_logits in {time.perf_counter() - t0:.1f} s")
    return {"q llm_loss": row, "q llm_logits masked": masked}


def _cpu_f32(tree):
    if isinstance(tree, dict):
        return {k: _cpu_f32(v) for k, v in tree.items()}
    return tree.detach().float().cpu()


def q_lightconv(flush) -> dict:
    """`lightweight_conv` and `dynamic_conv` at the width of fairseq's
    `lightconv_wmt_en_de_big` (Wu et al. 2019: C 1024, 16 heads), K 3, 7,
    15 and 31, causal and centred, B 4 x T 1024 in bf16 on the card, each
    held against the same call in float64 on the CPU (relative L2 within
    REL_L2_TOL: the bf16 output's rounding), with its device ms a call.
    Plain torch ops, no kernel: nothing launches."""
    import torch

    from omni_avsr_tpu_torch.ops.lightconv import dynamic_conv, lightweight_conv

    t0 = time.perf_counter()
    rng = np.random.RandomState(21)
    x = torch.from_numpy(rng.randn(LC_B, LC_T, LC_C).astype(np.float32)).to(DEV, torch.bfloat16)
    x64 = x.double().cpu()
    bias = torch.from_numpy(rng.randn(LC_C).astype(np.float32) * 0.1).to(DEV)
    fns = counters()
    reset_counts(fns)
    cases = []
    for K in LC_KERNELS:
        w = torch.from_numpy(rng.randn(LC_H, K).astype(np.float32)).to(DEV)
        wl = torch.from_numpy((rng.randn(LC_C, LC_H * K) / np.sqrt(LC_C)).astype(np.float32)) \
            .to(DEV, torch.bfloat16)
        for pad_name, padding_l in (("causal", K - 1), ("centred", K // 2)):
            for fn_name in ("lightweight", "dynamic"):
                if fn_name == "lightweight":
                    args = (w, bias)
                    call = lambda xx, ww, bb: lightweight_conv(  # noqa: E731
                        xx, ww, padding_l, weight_softmax=True, bias=bb)
                else:
                    args = (wl, bias)
                    call = lambda xx, ww, bb: dynamic_conv(  # noqa: E731
                        xx, xx, ww, LC_H, K, padding_l, weight_softmax=True, conv_bias=bb)
                y = call(x, *args)
                ref = call(x64, *(a.double().cpu() for a in args))
                rel = rel_l2(y, ref)
                err = float((y.double().cpu() - ref).abs().max())
                if rel > REL_L2_TOL or y.dtype != torch.bfloat16 or y.shape != x.shape:
                    raise RuntimeError(f"(q) {fn_name} K {K} {pad_name}: relative L2 {rel:.3g} "
                                       f"vs float64 on the CPU, dtype {y.dtype}")
                ms = time_ms(lambda: call(x, *args), flush, iters=20)
                cases.append(dict(fn=fn_name, K=K, padding=pad_name, padding_l=padding_l,
                                  ms=ms, rel_l2_vs_cpu_f64=rel, max_abs_err=err))
                log("q", f"lightconv {json.dumps(cases[-1])}")
    used = {n: fn.launches for n, fn in fns.items()}
    if used != counts():
        raise RuntimeError(f"(q) lightconv launched {used}")
    log("q", f"lightconv in {time.perf_counter() - t0:.1f} s")
    return {"q lightconv": dict(config=f"(q) lightconv_wmt_en_de_big: B {LC_B} x T {LC_T} x C "
                                f"{LC_C}, H {LC_H}, bf16", cases=cases, launches=used)}


def q_checkify() -> dict:
    """`checkify_step` around (t)'s full-width train step: the first step
    of a fresh engine wrapped returns the loss of the same first step
    unwrapped (another fresh engine, the same weights, seed and draws) bit
    for bit, launching the same kernels; `count_nonfinite` of the trainable
    tree after it is 0; a step fed one NaN in its audio raises
    FloatingPointError naming an op, and so does a division by zero in a
    backward on the card."""
    import torch

    from omni_avsr_tpu_torch.bridge import init_params
    from omni_avsr_tpu_torch.config import TrainConfig
    from omni_avsr_tpu_torch.models.omni import flagship
    from omni_avsr_tpu_torch.ops.audio_frontend import whisper_token_len
    from omni_avsr_tpu_torch.train.engine import OmniEngine
    from omni_avsr_tpu_torch.utils.profiling import checkify_step, count_nonfinite

    t0 = time.perf_counter()
    model = flagship(tiny=False)
    bank = (np.random.RandomState(1234).randn(10 * 16000) * 0.1).astype(np.float32)
    batch = train_batch(model.tok, B_TRAIN, FRAMES_TRAIN, TOKENS_TRAIN)
    trim = -(-int(whisper_token_len(FRAMES_TRAIN * 640)) // 25) * 25
    fns = counters()

    def first_step(wrap: bool):
        params = init_params(model.cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
        engine = OmniEngine(model, params, TrainConfig(lr=1e-3), noise_bank=bank, seed=0,
                            device=DEV)
        del params
        engine.sample_rates = lambda: (4, 2)
        step = checkify_step(engine.train_step) if wrap else engine.train_step
        reset_counts(fns)
        t = time.perf_counter()
        loss = step({**batch, "audio_trim_len": trim})
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        return engine, step, loss.detach().float().cpu(), dt, {
            n: fn.launches for n, fn in fns.items()}

    engine, _, plain, plain_s, plain_used = first_step(False)
    del engine
    torch.cuda.empty_cache()
    engine, step, checked, checked_s, checked_used = first_step(True)
    if not (torch.equal(plain.view(torch.int32), checked.view(torch.int32))
            and checked_used == plain_used and bool(torch.isfinite(checked))):
        raise RuntimeError(f"(q) checkify_step: loss {checked.item()!r} vs unwrapped "
                           f"{plain.item()!r}, launches {checked_used} vs {plain_used}")
    nonfinite = int(count_nonfinite(engine.state.trainable))
    if nonfinite:
        raise RuntimeError(f"(q) {nonfinite} non-finite trainable elements after the step")
    bad = {**batch, "audio": batch["audio"].copy(), "audio_trim_len": trim}
    bad["audio"][0, 1000] = np.nan
    raised = None
    try:
        step(bad)
    except FloatingPointError as e:
        raised = str(e)
    if raised is None or "op: aten." not in raised:
        raise RuntimeError(f"(q) checkify_step on a step fed a NaN: {raised!r}")
    # the mode follows the autograd engine onto the card's backward thread:
    # the gradient of sqrt(x * x) at 0 divides by zero there
    x = torch.zeros(4, device=DEV, requires_grad=True)
    backward_raised = None
    try:
        checkify_step(lambda v: torch.autograd.grad(torch.sqrt(v * v).sum(), v)[0])(x)
    except FloatingPointError as e:
        backward_raised = str(e)
    if backward_raised is None or "division by zero" not in backward_raised:
        raise RuntimeError(f"(q) checkify_step missed a division by zero in a backward on the "
                           f"card: {backward_raised!r}")
    del engine, step
    torch.cuda.empty_cache()
    row = dict(config=f"(q) checkify_step, train B {B_TRAIN} x {FRAMES_TRAIN} frames, pad30s",
               loss=checked.item(), loss_unwrapped=plain.item(), bit_equal=True,
               s_first_step_unwrapped=plain_s, s_first_step_checked=checked_s,
               count_nonfinite_after=nonfinite, nan_step_raised=raised,
               backward_raised=backward_raised, launches=checked_used)
    log("q", json.dumps(row))
    log("q", f"checkify in {time.perf_counter() - t0:.1f} s")
    return {"q checkify": row}


def last_modules_phase(flush) -> dict:
    """(q): `llm_loss` and the masked `llm_logits`, lightconv and
    `checkify_step` at full width (the host-only entry points run in the
    CLI phase)."""
    t0 = time.perf_counter()
    rows = q_llm_loss(flush)
    rows.update(q_lightconv(flush))
    rows.update(q_checkify())
    log("q", f"(q) in {time.perf_counter() - t0:.1f} s")
    return rows



# ------------------------------ (r): sequence parallelism, several ranks

R_QWEN = "Qwen/Qwen2.5-0.5B"  # 14 / 2 heads: neither divides by tp 4, the attention replicates
R_GRAD_SEED, R_STEP_SEED = 20261018, 7  # the draws of (r)'s grads runs and timed steps
R_LOSS_RTOL = 1e-3  # (r)'s losses against the reference run; the grads REL_L2_TOL
R_DIST_TIMEOUT_S = 300.0  # any collective of (r)'s gloo ranks


def qwen_small_model():
    """The flagship on the registry's Qwen2.5-0.5B (24 layers, hidden 896,
    FFN 4864, 14 / 2 heads at D 64, tied embeddings), the 30 s window."""
    from omni_avsr_tpu_torch.data.tokenizer import synthetic_tokenizer
    from omni_avsr_tpu_torch.models.omni import registry_model

    return registry_model(R_QWEN, synthetic_tokenizer("qwen", base_vocab=QWEN_BASE_VOCAB))


@contextlib.contextmanager
def routed(own: list, replay=None):
    """Each balanced routing call's assignments (the kernel's, on the card)
    appended to `own` on the host; with `replay` (another run's `own`) each
    call returns that run's assignments instead, call for call. Routing is
    discrete: tp's partial sums move the router logits at bf16 level and
    flip near-tied choices (`moe_routes`), so runs compare their grads on
    one set of choices and count the calls whose own choice differs."""
    import omni_avsr_tpu_torch.models.moe as moe_mod

    fn = moe_mod.balanced_assignment

    def route(scores, capacity):
        out = fn(scores, capacity)
        own.append(out.cpu())
        if replay is None:
            return out
        want = replay[len(own) - 1]
        if want.shape != out.shape:
            raise RuntimeError(f"routing replay: call {len(own) - 1} routes {out.shape[0]} rows, "
                               f"the recorded run {want.shape[0]}")
        return want.to(device=out.device, dtype=out.dtype)

    moe_mod.balanced_assignment = route
    try:
        yield
    finally:
        moe_mod.balanced_assignment = fn
    if replay is not None and len(own) != len(replay):
        raise RuntimeError(f"routing replay: {len(own)} calls, recorded {len(replay)}")


def routes_differing(a: list, b: list) -> tuple:
    """(calls, rows) of two runs' routing whose assignments differ."""
    if len(a) != len(b):
        raise RuntimeError(f"routing calls: {len(a)} against {len(b)}")
    rows = [int((x != y).sum()) for x, y in zip(a, b)]
    return sum(r > 0 for r in rows), sum(rows)


def r_grads(engine, batch, trim: int):
    """One train step's loss and trainable grads before the optimizer, as
    `OmniEngine._update` reduces them (under the engine's mesh gathered
    from every rank's slices, on every rank; a pipeline's messages
    drained), draws from R_GRAD_SEED."""
    import torch

    from omni_avsr_tpu_torch.parallel import collectives as par
    from omni_avsr_tpu_torch.parallel.partitioning import gather_params
    from omni_avsr_tpu_torch.parallel.pipeline import anchors, drain
    from omni_avsr_tpu_torch.train.engine import _unflatten
    from omni_avsr_tpu_torch.train.state import tree_leaves

    arrays, trim_len = engine._arrays({**batch, "audio_trim_len": trim})
    engine._rows(arrays)
    leaves = list(tree_leaves(engine.state.trainable))
    engine.generator.manual_seed(R_GRAD_SEED)
    with par.scope(engine.par):
        total, _ = engine._loss(arrays, 4, 2, trim_len, is_train=True)
        extra = anchors() if engine.pipeline is not None else []  # the forward's receives
        grads = torch.autograd.grad(total, leaves + extra, allow_unused=True)[:len(leaves)]
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        if engine.par is not None:
            drain()
            grads = par.reduce_grads(grads, list(tree_leaves(engine.specs)), engine.par)
            grads = list(tree_leaves(gather_params(
                engine.mesh, _unflatten(engine.state.trainable, grads), engine.specs)))
            total = par.all_reduce(total, engine.par.dp)
    return float(total.detach()), torch.cat([g.detach().float().reshape(-1) for g in grads]).cpu()


def r_step(engine, batch, trim: int, fns) -> dict:
    """The timed `OmniEngine.train_step` (the entry point a user calls),
    every kernel counter set to 0 just before and read just after, its draws
    from R_STEP_SEED (so every run drops the same AV-HuBERT layers)."""
    import torch

    engine.generator.manual_seed(R_STEP_SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fns)
    t = time.perf_counter()
    loss = float(engine.train_step({**batch, "audio_trim_len": trim}))  # a host sync
    dt = time.perf_counter() - t
    if not np.isfinite(loss):
        raise RuntimeError(f"train step: loss {loss}")
    return dict(step_loss=loss, s_per_step=dt, launches={k: fn.launches for k, fn in fns.items()},
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                avhubert_layers_run=engine.model.last_video_layers)


def state_vectors(state) -> dict:
    """A train state's f32 masters and AdamW moments, each leaf list
    flattened into one host vector."""
    import torch

    from omni_avsr_tpu_torch.train.state import tree_leaves

    def flat(leaves):
        return torch.cat([x.detach().float().reshape(-1) for x in leaves]).cpu()

    opt = state.opt_state
    return dict(masters=flat(tree_leaves(state.trainable)), mu=flat(opt.mu), nu=flat(opt.nu))


def stub_card_counters() -> None:
    """A CPU rehearsal of a rank function: the card's synchronise and memory
    counters as no-ops, as the parent's rehearsal stubs them."""
    import torch

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated", "memory_reserved"):
        setattr(torch.cuda, name, lambda *a, **k: 0)


def release_card() -> None:
    """A rank function's last act: its tensors collected and the caching
    allocator's blocks handed back, so that the next case's ranks (other
    processes) find the card's memory free."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def r_probe_rank(dev: str) -> dict:
    """One gloo rank of the multi-rank phase's probe: tensors on the card
    through gloo's all_gather (f32 and the int64 of the sharded selection's
    indices), all_reduce and broadcast, and through the port's gathers and
    reduce-scatter over a (1, world) mesh's tp axis (gloo's reduce-scatter
    is an all-reduce and a slice), each held to the values it must give."""
    import torch
    import torch.distributed as dist

    from omni_avsr_tpu_torch.config import MeshConfig
    from omni_avsr_tpu_torch.parallel import collectives as par
    from omni_avsr_tpu_torch.parallel.mesh import axis, make_mesh

    r, n = dist.get_rank(), dist.get_world_size()
    base = torch.arange(4 * n, dtype=torch.float32, device=dev)
    x = base + 100 * r
    every = torch.stack([base + 100 * i for i in range(n)])
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x)
    ids = torch.arange(3, dtype=torch.int64, device=dev) + (2**40 + 10 * r)  # past 32 bits
    every_ids = torch.stack([ids - 10 * r + 10 * i for i in range(n)])
    id_parts = [torch.empty_like(ids) for _ in range(n)]
    dist.all_gather(id_parts, ids)
    total = x.clone()
    dist.all_reduce(total)
    sent = base.clone() if r == 0 else torch.zeros_like(base)
    dist.broadcast(sent, 0)
    tp = axis(make_mesh(MeshConfig(dp=1, tp=n)), "tp")
    gathered = par.all_gather(x[None], tp, 0)
    gathered_ids = par.all_gather(ids[None], tp, 0)
    scattered = par._reduce_scatter(x, tp, 0)
    checks = {"all_gather": torch.equal(torch.stack(parts), every),
              "all_gather int64": torch.equal(torch.stack(id_parts), every_ids),
              "all_reduce": torch.equal(total, every.sum(0)),
              "broadcast": torch.equal(sent, base),
              "port gather": torch.equal(gathered, every),
              "port gather int64": torch.equal(gathered_ids, every_ids),
              "port reduce_scatter": torch.equal(scattered, every.sum(0)[4 * r:4 * (r + 1)])}
    out = (*parts, *id_parts, total, sent, gathered, gathered_ids, scattered)
    devices = {str(t.device) for t in out}
    if not all(checks.values()) or devices != {str(x.device)}:
        raise RuntimeError(f"gloo probe, rank {r}: {checks}, results on {devices}")
    return dict(rank=r, backend=dist.get_backend(), device=str(x.device), checks=checks)


def p2p_probe_rank(dev: str) -> dict:
    """One of two gloo ranks of the point-to-point probe: rank 0 sends a
    tensor on the card with `dist.isend`, rank 1 receives it into a tensor
    on the card with `dist.recv` and compares it with what was sent (the
    pipeline's messages, `parallel/pipeline.py::_Link`)."""
    import torch
    import torch.distributed as dist

    want = torch.arange(4096, dtype=torch.float32, device=dev) * 3 + 7
    if dist.get_rank() == 0:
        dist.isend(want, 1).wait()
        return dict(rank=0, sent=True)
    got = torch.zeros_like(want)
    dist.recv(got, 0)
    return dict(rank=1, equal=bool(torch.equal(got, want)), device=str(got.device))


def p2p_probe(work: Path) -> dict:
    """The point-to-point probe in a short-lived pool of two ranks of its
    own (gloo may hand a card pointer to its TCP transport and kill the
    process, which must not take down the cases' pools). Returns what
    happened: "passed", "wrong values", "refused" (a rank raised), "a rank
    died" or "no answer"; it does not raise."""
    from omni_avsr_tpu_torch.parallel.launch import RankPool

    work.mkdir(parents=True, exist_ok=True)
    try:
        with RankPool(2, str(work), timeout_s=30) as pool:
            ranks = pool.run(p2p_probe_rank, DEV, timeout_s=90)
    except TimeoutError as e:
        return dict(outcome="a rank died" if "exited" in str(e) else "no answer", detail=str(e))
    except RuntimeError as e:
        return dict(outcome="refused", detail=str(e)[:600])
    return dict(outcome="passed" if ranks[1]["equal"] else "wrong values", ranks=ranks)


def r_rank_run(build, build_args, batch, trim: int, bank, mesh_sizes, runs, replay, dev: str):
    """What each gloo rank of (r) and (v) runs (a `RankPool` process a rank,
    every rank on the one card), `release_card` at the end."""
    try:
        return _r_rank_run(build, build_args, batch, trim, bank, mesh_sizes, runs, replay, dev)
    finally:
        release_card()


def _r_rank_run(build, build_args, batch, trim: int, bank, mesh_sizes, runs, replay, dev: str):
    """`build(*build_args)` with random weights from seed 0, and for each
    (label, options) of `runs` an engine on a mesh of `mesh_sizes`
    (options: `OmniEngine`'s `sequence_parallel` and `fsdp`, and
    `microbatches` for a GPipe plan over pp) on this rank's dp rows of the
    global `batch`: the grads run (`r_grads`), then the timed step
    (`r_step`), each with the routing replayed from `replay` (the
    reference's grads and step routing) and its own choices recorded.
    Returns {label: row}: this rank's loss, step, launches, peak and routing
    choices, and on rank 0 the whole grads and the whole state after the
    step (`OmniEngine.full_state`: masters and AdamW moments)."""
    import torch
    import torch.distributed as dist

    from omni_avsr_tpu_torch.bridge import init_params
    from omni_avsr_tpu_torch.config import MeshConfig, TrainConfig
    from omni_avsr_tpu_torch.parallel.distributed import host_shard_slice
    from omni_avsr_tpu_torch.parallel.mesh import axis, make_mesh
    from omni_avsr_tpu_torch.parallel.pipeline import PipelinePlan
    from omni_avsr_tpu_torch.train.engine import OmniEngine

    if dev != "cuda":
        stub_card_counters()
    torch.backends.cuda.matmul.allow_tf32 = False  # as main() sets them
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    model = build(*build_args)
    mesh = make_mesh(MeshConfig(**mesh_sizes))
    dp = axis(mesh, "dp")
    rows = host_shard_slice(len(batch["tokens"]), dp.rank, dp.size)
    mine = {k: v[rows] if isinstance(v, np.ndarray) else v for k, v in batch.items()}
    fns = counters()
    out = {}
    for label, opts in runs:
        opts = dict(opts)
        m = opts.pop("microbatches", None)
        plan = PipelinePlan(mesh, num_microbatches=m, dp_axis="dp") if m else None
        params = init_params(model.cfg, torch.Generator(device=dev).manual_seed(0), dev)
        engine = OmniEngine(model, params, TrainConfig(lr=1e-3), noise_bank=bank, seed=0,
                            device=dev, mesh=mesh, pipeline=plan, **opts)
        del params  # the engine holds this rank's slices
        engine.sample_rates = lambda: (4, 2)
        own, own_step = [], []
        with routed(own, replay[0]):
            loss, grads = r_grads(engine, mine, trim)
        setup = time.perf_counter() - t
        with routed(own_step, replay[1]):
            step = r_step(engine, mine, trim, fns)
        state = engine.full_state()
        row = dict(loss=loss, routes=own, step_routes=own_step, setup_and_grads_s=setup,
                   tp_blocks=sorted(engine.par.tp_blocks), **step)
        if dist.get_rank() == 0:
            row.update(grads=grads, **state_vectors(state))
        out[label] = row
        del engine, grads, state
        release_card()
        t = time.perf_counter()
    return out


def r_reference(label: str, build, build_args, fns) -> dict:
    """The meshless reference of (r) and (v) in this process on (t)'s batch
    (B_TRAIN x FRAMES_TRAIN, rates (4, 2)): the grads run and the timed
    step, the routing of each recorded, the state after the step; the
    step's launches held to what the path must give. Freed before the
    ranks run; returns its row, batch and trim."""
    import torch

    from omni_avsr_tpu_torch.bridge import init_params
    from omni_avsr_tpu_torch.config import TrainConfig
    from omni_avsr_tpu_torch.ops.attention import FLASH_MIN_T_TRAIN
    from omni_avsr_tpu_torch.ops.audio_frontend import whisper_token_len
    from omni_avsr_tpu_torch.train.engine import OmniEngine

    bank = (np.random.RandomState(1234).randn(10 * 16000) * 0.1).astype(np.float32)
    trim = -(-int(whisper_token_len(FRAMES_TRAIN * 640)) // 25) * 25
    model = build(*build_args)
    batch = train_batch(model.tok, B_TRAIN, FRAMES_TRAIN, TOKENS_TRAIN)
    params = init_params(model.cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    engine = OmniEngine(model, params, TrainConfig(lr=1e-3), noise_bank=bank, seed=0, device=DEV)
    del params
    engine.sample_rates = lambda: (4, 2)
    own, own_step = [], []
    with routed(own):
        loss, grads = r_grads(engine, batch, trim)
    with routed(own_step):
        step = r_step(engine, batch, trim, fns)
    ref = dict(loss=loss, routes=own, step_routes=own_step, grads=grads, **step,
               **state_vectors(engine.state))
    del engine
    torch.cuda.empty_cache()
    lengths = llm_lengths(model, trim, 4, 2, FRAMES_TRAIN, TOKENS_TRAIN)
    ref["flash_tasks"] = sum(n >= FLASH_MIN_T_TRAIN for n in lengths.values())
    want = train_launches(model, ref["flash_tasks"], ref["avhubert_layers_run"])
    if ref["launches"] != want:
        raise RuntimeError(f"{label} meshless step: kernel launches {ref['launches']}, expected "
                           f"{want}")
    row = dict(config=f"{label} meshless train step on the card, alone", loss=loss,
               step_loss=ref["step_loss"], s_per_step=ref["s_per_step"],
               peak_gib=ref["peak_gib"], launches=ref["launches"], llm_lengths=lengths,
               avhubert_layers_run=ref["avhubert_layers_run"], routing_calls=len(own))
    log("multirank", json.dumps(row))
    return dict(ref=ref, row=row, batch=batch, trim=trim, bank=bank, label=label)


def r_compare(label: str, got: dict, ref: dict, ref_label: str) -> dict:
    """A run's loss and grads against a reference run's (loss within
    R_LOSS_RTOL relative, grads within REL_L2_TOL relative L2, both on one
    set of routing choices), its state after the step (masters, AdamW's
    first and second moments, each within REL_L2_TOL relative L2), and the
    routing calls whose own choice differed."""
    rel = rel_l2(got["grads"], ref["grads"])
    dl = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    if not (np.isfinite(got["loss"]) and np.isfinite(rel)):
        raise RuntimeError(f"{label}: loss {got['loss']}, grads relative L2 {rel}")
    if rel > REL_L2_TOL or dl > R_LOSS_RTOL:
        raise RuntimeError(f"{label} vs {ref_label}: loss {got['loss']} vs {ref['loss']}, grads "
                           f"relative L2 {rel:.3g}")
    state = {k: rel_l2(got[k], ref[k]) for k in ("masters", "mu", "nu")}
    if not max(state.values()) <= REL_L2_TOL:
        raise RuntimeError(f"{label} vs {ref_label}: the state after the step, relative L2 "
                           f"{state}")
    calls, rows = routes_differing(got["routes"], ref["routes"])
    return dict(vs=ref_label, loss=got["loss"], ref_loss=ref["loss"], loss_rel_diff=dl,
                grad_rel_l2=rel, state_rel_l2=state, routing_calls=len(got["routes"]),
                routing_rows=sum(len(r) for r in got["routes"]),
                routing_calls_differing=calls, routing_rows_differing=rows)


def r_case(label: str, pool, reference: dict, build, build_args, mesh_sizes, runs, smi: str,
           pairs=()) -> dict:
    """One multi-rank training case: `runs` (label, options) on the pool's
    ranks on a mesh of `mesh_sizes`, against `reference` (`r_reference`,
    already freed): every rank's launches held to the reference step's (a
    pipeline stage's to its own layers'), every rank's routing to rank
    0's, each run's loss, grads and state to the reference's, and to
    another run's for each (run, other) of `pairs`."""
    ref = reference["ref"]
    t = time.perf_counter()
    replay = (ref["routes"], ref["step_routes"])
    ranks = pool.run(r_rank_run, build, build_args, reference["batch"], reference["trim"],
                     reference["bank"], mesh_sizes, runs, replay, DEV, timeout_s=1200)
    log("multirank", f"{label}: {len(ranks)} gloo ranks, runs {[r for r, _ in runs]}, in "
        f"{time.perf_counter() - t:.1f} s")
    mesh = ", ".join(f"{k} {v}" for k, v in mesh_sizes.items() if v > 1)
    rows = {}
    for run, opts in runs:
        rr = [ranks[i][run] for i in range(len(ranks))]
        want = ref["launches"]
        if opts.get("microbatches"):  # a stage runs its share of the LLM's layers
            model = build(*build_args)
            want = train_launches(model, ref["flash_tasks"], ref["avhubert_layers_run"],
                                  llm_layers=model.cfg.llm.num_layers // mesh_sizes["pp"])
        for i, row in enumerate(rr):
            if row["launches"] != want:
                raise RuntimeError(f"{label} {run} rank {i}: kernel launches {row['launches']}, "
                                   f"expected {want}")
            if routes_differing(row["routes"], rr[0]["routes"])[0]:
                raise RuntimeError(f"{label} {run}: rank {i}'s routing differs from rank 0's")
        agree = [r_compare(f"{label} {run}", rr[0], ref, "meshless")]
        agree += [r_compare(f"{label} {run}", rr[0], ranks[0][other], other)
                  for a, other in pairs if a == run]
        options = "".join(f", {k} {v}" for k, v in opts.items())
        rows[f"{label} {run}"] = dict(
            config=f"{label} {mesh}{options}, {len(rr)} gloo ranks on one card",
            tp_blocks=rr[0]["tp_blocks"], agreement=agree, launches=rr[0]["launches"],
            launches_by_rank=[r["launches"] for r in rr],
            s_per_step_by_rank=[r["s_per_step"] for r in rr],
            peak_gib_by_rank=[r["peak_gib"] for r in rr],
            step_loss_by_rank=[r["step_loss"] for r in rr],
            setup_and_grads_s_by_rank=[r["setup_and_grads_s"] for r in rr], card=smi)
        log("multirank", json.dumps(rows[f"{label} {run}"]))
    return rows


def flagship_model(window: str):
    """The flagship at full width and depth with Whisper's `window`."""
    from omni_avsr_tpu_torch.models.omni import flagship

    return flagship(tiny=False, whisper_input_mode=window)


def vocab_model(build, build_args, vocab: int):
    """`build(*build_args)` with its LLM at `vocab` tokens (`with_vocab`)."""
    return with_vocab(build(*build_args), vocab)


def qwen7b_model():
    """(e)'s model: the flagship on the registry's Qwen2.5-7B, the bucketed
    window."""
    from omni_avsr_tpu_torch.data.tokenizer import synthetic_tokenizer
    from omni_avsr_tpu_torch.models.omni import registry_model

    return registry_model(QWEN_E, synthetic_tokenizer("qwen", base_vocab=QWEN_BASE_VOCAB),
                          whisper_input_mode="bucket")


def u_launches(model, tp: int, steps: int, select_kernel: bool):
    """What one served batch must launch on each rank of a tp mesh: B1 in
    every LLM layer a decode step (its heads' shard), B2 in the towers'
    6 matrices a layer and in the LLM's 4 a layer and its lm_head at the
    prefill and each step (their shards), and with `select_kernel` B5 once
    a step on the rank's vocabulary shard."""
    llm = model.cfg.llm
    tower = 6 * (model.cfg.whisper.num_layers + model.cfg.avhubert.encoder_layers)
    return counts(B1=llm.num_layers * steps, B2=tower + (4 * llm.num_layers + 1) * (1 + steps),
                  B5=steps if select_kernel else 0)


def u_reference(build, build_args, items, select_kernel: bool) -> dict:
    """The meshless int8 `Transcriber` in this process (freed on return):
    the ids of `items` as one batch at K beams and N new tokens, and the
    first request's prefix, prefill and first decode steps (`llm_steps`)."""
    import torch

    from omni_avsr_tpu_torch.bridge import init_params
    from omni_avsr_tpu_torch.serve import Transcriber, pad_batch

    t0 = time.perf_counter()
    model = build(*build_args)
    params = init_params(model.cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    t = Transcriber(model, params, num_beams=K, max_new_tokens=N, quantize="int8", device=DEV,
                    select_kernel=select_kernel)
    del params
    batch, trim = pad_batch(items, "audiovisual")
    ids = t.decode_ids(batch, "audiovisual", 4, 2, trim, K)
    prefix, valid = served_prefix(t, items[0])
    logits, tokens = llm_steps(t, prefix, valid)
    out = dict(ids=ids.cpu(), steps=t.last_decode_steps, logits=[x.float().cpu() for x in logits],
               tokens=[x.cpu() for x in tokens], prefix=prefix.cpu(), valid=valid.cpu())
    del t
    release_card()
    log("multirank", f"the meshless Transcriber: {out['steps']} decode steps, "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def u_rank_run(build, build_args, items, select_kernel: bool, tp: int, ref_prefix, ref_valid,
               ref_tokens, turns: bool, dev: str) -> dict:
    """What each gloo rank of (u) runs, `release_card` at the end."""
    try:
        return _u_rank_run(build, build_args, items, select_kernel, tp, ref_prefix, ref_valid,
                           ref_tokens, turns, dev)
    finally:
        release_card()


def _u_rank_run(build, build_args, items, select_kernel: bool, tp: int, ref_prefix, ref_valid,
                ref_tokens, turns: bool, dev: str) -> dict:
    """`Transcriber(mesh=...)` on a (1, tp) mesh at int8, K beams and N new
    tokens, from `build(*build_args)`'s random weights of seed 0 (each rank
    draws the whole tree, quantises and cuts its shard; with `turns` the
    ranks build one after the other); the ids of `items` as one batch
    (warm), then one timed `transcribe_many` batch, the kernel counters
    set to 0 just before it and read just after; this rank's prefix of the
    first request against the reference's, and the reference's prefix
    through this rank's LLM with the reference's tokens (`llm_steps`, the
    logits gathered over tp); on the first decode step's logits, the
    selection `_fused_select_sharded` merges from this rank's vocabulary
    shard and the others' held to the unsharded selection's: the maxima,
    candidates and indices bit-equal, the lse within rtol 1e-5. Returns
    this rank's row, with the logits on rank 0."""
    import torch
    import torch.distributed as dist

    from omni_avsr_tpu_torch.bridge import init_params
    from omni_avsr_tpu_torch.config import MeshConfig
    from omni_avsr_tpu_torch.decode.decoding import (_fused_select_sharded,
                                                     merge_select_shards, select_shard)
    from omni_avsr_tpu_torch.parallel.mesh import axis, make_mesh
    from omni_avsr_tpu_torch.serve import Transcriber, pad_batch

    if dev != "cuda":
        stub_card_counters()
    torch.backends.cuda.matmul.allow_tf32 = False  # as main() sets them
    torch.backends.cudnn.allow_tf32 = False
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh(MeshConfig(dp=1, tp=tp))
    model = build(*build_args)
    log("multirank", f"rank {rank}: {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved "
        f"before the build")
    t = built = None
    for turn in range(world) if turns else (None,):
        if turn in (None, rank):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params = init_params(model.cfg, torch.Generator(device=dev).manual_seed(0), dev)
            t = Transcriber(model, params, num_beams=K, max_new_tokens=N, quantize="int8",
                            device=dev, select_kernel=select_kernel, mesh=mesh)
            del params
            release_card()
            torch.cuda.synchronize()
            built = dict(build_s=time.perf_counter() - t0,
                         build_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         built_gib=torch.cuda.memory_allocated() / 2**30,
                         reserved_gib=torch.cuda.memory_reserved() / 2**30)
            log("multirank", f"rank {rank}: Transcriber(mesh) built: {json.dumps(built)}")
        if turn is not None:
            dist.barrier()
    batch, trim = pad_batch(items, "audiovisual")
    ids = t.decode_ids(batch, "audiovisual", 4, 2, trim, K)  # the first use of these shapes
    log("multirank", f"rank {rank}: the first batch decoded, {t.last_decode_steps} steps")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fns = counters()
    reset_counts(fns)
    t0 = time.perf_counter()
    texts = t.transcribe_many(items)
    torch.cuda.synchronize()
    run = dict(s=time.perf_counter() - t0, steps=t.last_decode_steps, texts=texts,
               launches={k: fn.launches for k, fn in fns.items()})
    peak = torch.cuda.max_memory_allocated() / 2**30
    prefix, _ = served_prefix(t, items[0])
    logits, _ = llm_steps(t, ref_prefix.to(dev), ref_valid.to(dev), [x.to(dev) for x in ref_tokens])
    x = logits[1].float().reshape(1, K, -1)
    Vs, k2 = x.shape[-1] // tp, 2 * K
    merged = _fused_select_sharded(x[..., rank * Vs:(rank + 1) * Vs].contiguous(), k2,
                                   axis(mesh, "tp"), select_kernel)
    mx, se, vals, idx = select_shard(x, k2, select_kernel)
    want = merge_select_shards(mx[..., None], se[..., None], vals, idx, k2)
    if not all(torch.equal(merged[i], want[i]) for i in (0, 2, 3)):
        raise RuntimeError(f"rank {rank}: the merged selection's maxima, candidates or indices "
                           f"differ from the unsharded selection's")
    torch.testing.assert_close(merged[1], want[1], rtol=1e-5, atol=0)
    row = dict(rank=rank, ids=ids.cpu(), steps=t.last_decode_steps, run=run, peak_gib=peak,
               prefix_rel_l2=rel_l2(prefix, ref_prefix), attn_route=t.attn_route,
               merged_lse_max_abs_err=(merged[1] - want[1]).abs().max().item(),
               tp_blocks=sorted(t.par.tp_blocks), **built)
    if rank == 0:
        row["logits"] = [x.float().cpu() for x in logits]
    return row


def u_case(label: str, pool, ref: dict, build, build_args, tp: int, items, select_kernel: bool,
           turns: bool, smi: str) -> dict:
    """One (u) case against `ref` (`u_reference`, already freed):
    `Transcriber(mesh=...)` on the pool's ranks (`u_rank_run`): every
    rank's launches held to `u_launches` for its decode steps, every rank's
    merged selection to the unsharded one (in the rank), every rank's ids
    to rank 0's, and rank 0's logits (prefill and two decode steps on
    the reference's prefix and tokens) and log-probabilities within
    REL_L2_TOL of the reference's; the share of the ids equal to the
    reference's printed (near-flat random logits: bf16 partial sums may
    flip a beam)."""
    import torch

    t = time.perf_counter()
    ranks = pool.run(u_rank_run, build, build_args, items, select_kernel, tp, ref["prefix"],
                     ref["valid"], ref["tokens"], turns, DEV, timeout_s=1800)
    model = build(*build_args)
    for r in ranks:
        run = r["run"]
        want = u_launches(model, tp, run["steps"], select_kernel)
        if run["launches"] != want:
            raise RuntimeError(f"{label} rank {r['rank']}: kernel launches {run['launches']}, "
                               f"expected {want} for {run['steps']} decode steps")
        if len(run["texts"]) != len(items) or not all(run["texts"]):
            raise RuntimeError(f"{label} rank {r['rank']}: transcripts {run['texts']!r}")
        if not torch.equal(r["ids"], ranks[0]["ids"]):
            raise RuntimeError(f"{label}: rank {r['rank']}'s ids differ from rank 0's")
    logits = worst_rel_l2(ranks[0]["logits"], ref["logits"])
    logp = worst_rel_l2([torch.log_softmax(x, -1) for x in ranks[0]["logits"]],
                        [torch.log_softmax(x, -1) for x in ref["logits"]])
    if not max(logits, logp) <= REL_L2_TOL:
        raise RuntimeError(f"{label}: logits relative L2 {logits:.3g}, log-probabilities "
                           f"{logp:.3g}, against the meshless Transcriber")
    run0 = ranks[0]["run"]
    row = dict(config=f"{label}: Transcriber(mesh) tp {tp}, int8, {len(items)} requests, "
                      f"{len(ranks)} gloo ranks on one card",
               tp=tp, tp_blocks=ranks[0]["tp_blocks"], attn_route=ranks[0]["attn_route"],
               logits_rel_l2=logits, logprobs_rel_l2=logp,
               prefix_rel_l2_by_rank=[r["prefix_rel_l2"] for r in ranks],
               ids_equal_share=float((ranks[0]["ids"] == ref["ids"]).float().mean()),
               merged_lse_max_abs_err_by_rank=[r["merged_lse_max_abs_err"] for r in ranks],
               decode_steps=run0["steps"], meshless_decode_steps=ref["steps"],
               launches=run0["launches"], launches_by_rank=[r["run"]["launches"] for r in ranks],
               s_per_batch_by_rank=[r["run"]["s"] for r in ranks],
               build_s_by_rank=[r["build_s"] for r in ranks],
               build_peak_gib_by_rank=[r["build_peak_gib"] for r in ranks],
               peak_gib_by_rank=[r["peak_gib"] for r in ranks], card=smi,
               case_s=time.perf_counter() - t)
    log("multirank", json.dumps(row))
    log("multirank", f"{label} request 0: {run0['texts'][0][:120]}")
    return {label: row}


@contextlib.contextmanager
def case_pool(world: int, work: Path):
    """A `RankPool` of `world` ranks for the multi-rank cases, whose
    processes hand what a case frees back to the card through PyTorch's
    expandable segments: the next case's processes share the card (with
    whole segments, 23.9 GiB of a Qwen2.5-7B rank's build stayed reserved
    beside its 5.0 GiB tree on an NVIDIA H100 80GB HBM3, and the next
    rank's build ran out of memory).
    The spawned processes copy the environment as they start; this
    process's own is left as it was."""
    from omni_avsr_tpu_torch.parallel.launch import RankPool

    key = "PYTORCH_CUDA_ALLOC_CONF"
    old = os.environ.get(key)
    os.environ[key] = "expandable_segments:True"
    try:
        pool = RankPool(world, str(work), timeout_s=R_DIST_TIMEOUT_S)
    finally:
        if old is None:
            del os.environ[key]
        else:
            os.environ[key] = old
    with pool:
        yield pool


def multirank_phase(cases=None) -> dict:
    """(r), (u), (v): multi-rank paths at full width and depth on gloo ranks
    that share the one card (NCCL takes one rank a device; gloo stages each
    collective through host memory), each against the meshless run in this
    process, the case names of `cases` (None: all) in two pools of two and
    four ranks. First a probe of gloo on card tensors, and of its
    point-to-point pair in a pool of its own. (r1) the MoE flagship at tp 2
    with and without SP; (u1) the flagship with a 128256-token vocabulary
    served at tp 2 and tp 4 (`Transcriber(mesh=...)`, B5 per vocabulary
    shard); (u2) Qwen2.5-7B served at tp 2, the ranks building in turns;
    (v1) the flagship's train step at dp 2 and at dp 2 with FSDP; (v2) the
    MoE flagship at ep 2; the flagship at pp 2 only if the point-to-point
    pair passed; (r2) the flagship on Qwen2.5-0.5B at tp 4 with SP. The
    ranks share the card's SMs: their s/step and s/batch are not multi-card
    numbers."""
    import shutil

    def on(name):
        return cases is None or name in cases

    t0 = time.perf_counter()
    smi = card()
    fns = counters()
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_multirank"
    shutil.rmtree(work, ignore_errors=True)
    for world in (2, 4):
        (work / str(world)).mkdir(parents=True)
    p2p = p2p_probe(work / "p2p")
    log("multirank", f"gloo isend / recv of a card tensor between two ranks on {smi}: "
        f"{json.dumps(p2p)}")
    items = make_items((160, 160, 160), seed=0)  # (b)'s requests
    u1_model = (flagship_model, ("bucket",), VOCAB_D)  # (d)'s: Llama-3's 128256 tokens
    rows = {}
    moe = flagship = u1_ref = None
    with case_pool(2, work / "2") as pool:
        probe = pool.run(r_probe_rank, DEV)
        log("multirank", f"gloo probe on {smi}: {json.dumps(probe)}")
        if on("u1"):
            u1_ref = u_reference(vocab_model, u1_model, items, True)
            rows.update(u_case("(u1) tp 2", pool, u1_ref, vocab_model, u1_model, 2, items, True,
                               False, smi))
        if on("u2"):
            ref = u_reference(qwen7b_model, (), items, False)
            rows.update(u_case("(u2) Qwen2.5-7B tp 2", pool, ref, qwen7b_model, (), 2, items,
                               False, True, smi))
        if on("r1") or on("v2"):
            moe = r_reference("(r1, v2) MoE", moe_model, ("balanced", "pad30s"), fns)
            rows[f"{moe['label']} meshless"] = moe["row"]
        if on("r1"):
            rows.update(r_case("(r1) MoE", pool, moe, moe_model, ("balanced", "pad30s"),
                               dict(dp=1, tp=2), (("sp", dict(sequence_parallel=True)),
                                                  ("no sp", {})), smi, pairs=(("sp", "no sp"),)))
        if on("v1") or on("pp"):
            flagship = r_reference("(v1) flagship", flagship_model, ("pad30s",), fns)
            rows[f"{flagship['label']} meshless"] = flagship["row"]
        if on("v1"):
            rows.update(r_case("(v1) flagship", pool, flagship, flagship_model, ("pad30s",),
                               dict(dp=2, tp=1), (("dp", {}), ("fsdp", dict(fsdp=True))), smi,
                               pairs=(("fsdp", "dp"),)))
        if on("v2"):
            rows.update(r_case("(v2) MoE", pool, moe, moe_model, ("balanced", "pad30s"),
                               dict(dp=1, tp=1, ep=2), (("ep", {}),), smi))
        if on("pp") and p2p["outcome"] == "passed":
            rows.update(r_case("(v1) flagship", pool, flagship, flagship_model, ("pad30s",),
                               dict(dp=1, tp=1, pp=2), (("pp", dict(microbatches=2)),), smi))
    if on("r2") or on("u1"):
        with case_pool(4, work / "4") as pool:
            if on("r2"):
                qwen = r_reference("(r2) Qwen2.5-0.5B", qwen_small_model, (), fns)
                rows[f"{qwen['label']} meshless"] = qwen["row"]
                rows.update(r_case("(r2) Qwen2.5-0.5B", pool, qwen, qwen_small_model, (),
                                   dict(dp=1, tp=4), (("sp", dict(sequence_parallel=True)),),
                                   smi))
            if on("u1"):
                rows.update(u_case("(u1) tp 4", pool, u1_ref, vocab_model, u1_model, 4, items,
                                   True, False, smi))
    log("multirank", f"(r), (u), (v) in {time.perf_counter() - t0:.1f} s")
    return rows


def _padded(items):
    """(batch, modality, rates, trim) of `items` for `Transcriber.decode_ids`."""
    from omni_avsr_tpu_torch.serve import pad_batch

    batch, trim = pad_batch(items, "audiovisual")
    return batch, "audiovisual", 4, 2, trim


# ------------------------------------------------------ (o): the MoE decoder

MOE_EXPERTS = 8  # (o): the flagship's 16 MLPs each replaced by 8 SwiGLU experts


def moe_model(routing: str, whisper_input_mode: str):
    """The full-width flagship with MOE_EXPERTS experts in every LLM layer
    (`--moe-experts 8 --moe-routing <routing>`)."""
    from omni_avsr_tpu_torch.models.omni import OmniAVSR, flagship

    m = flagship(tiny=False, whisper_input_mode=whisper_input_mode)
    llm = dataclasses.replace(m.cfg.llm, moe_experts=MOE_EXPERTS, moe_routing=routing)
    return OmniAVSR(dataclasses.replace(m.cfg, llm=llm), m.tok, dtype=m.dtype)


def route_summary(label: str, store) -> dict:
    """What `moe_routes` held bit-equal on one kernel route: its calls and
    rows, and the first call's shape and loads."""
    import torch

    scores, cap, got = store[0]
    row = dict(case=label, calls=len(store), rows=sum(len(out) for _, _, out in store),
               first_N=scores.shape[0], E=scores.shape[1], first_capacity=cap,
               first_loads=torch.bincount(got.cpu().long(), minlength=scores.shape[1]).tolist(),
               bit_equal=True)
    log("MOE", f"real router logits: {json.dumps(row)}")
    return row


def moe_route_timing(flush, scores, cap: int, case: str) -> dict:
    """The routing kernel on one input: its assignments against the plain
    loop's on the same scores (raises unless bit-equal), its device time
    (the wrapper: the visiting order's sort and the launch; kernel_ms: the
    launch alone on that order) beside the plain loop's (on the card's
    tensors: a host sync per token), and the bound: one read of the scores,
    one write of the assignments."""
    import torch

    from omni_avsr_tpu_torch.ops import moe_route

    N, E = scores.shape
    got = moe_route.balanced_assignment(scores, cap).cpu().long()
    want = moe_route.balanced_assignment_plain(scores.cpu(), cap).long()
    differ = int((got != want).sum())
    if differ:
        raise RuntimeError(f"{case}: routing kernel vs plain loop differ in {differ} of {N} rows")
    order = moe_route.visiting_order(scores)
    out = torch.empty((N,), dtype=torch.int32, device=scores.device)
    launch, stream = moe_route._launcher(), torch.cuda.current_stream().cuda_stream
    nbytes = N * E * 4 + N * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, N * E / F32_FLOPS
    row = dict(case=case, N=N, E=E, capacity=cap, rows_differing=differ,
               max_abs_err=float((got - want).abs().max()),
               ms=time_ms(lambda: moe_route.balanced_assignment(scores, cap), flush),
               kernel_ms=time_ms(lambda: launch(scores.data_ptr(), order.data_ptr(),
                                                out.data_ptr(), N, E, cap, stream), flush),
               plain_ms=time_ms(lambda: moe_route.balanced_assignment_plain(scores, cap), flush,
                                iters=2),
               library_ms=None, bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    log("MOE", json.dumps(row))
    return row


def moe_phase(items, flush):
    """(o): the MoE flagship at full width (Whisper-medium, AV-HuBERT Large,
    Llama-3.2-1B with 8 experts a layer, random bf16 weights from a seed)
    served unquantised, as the JAX package must serve it: (b)'s requests
    with balanced routing (B1 once per layer and decode step, the routing
    kernel once per layer and forward), every routing call of the first
    batch bit-equal to the plain loop on its logits, the prefill and two
    decode steps held kernel against plain route; one
    batch with top-1 routing (no routing kernel); two train steps on (t)'s
    batch (the unfused three-task route, remat "dots": the routing kernel
    six times a layer, three tasks forward and recomputed), every routing
    call of the first step bit-equal, and one step's grads kernel against
    plain (its kernel route's calls bit-equal too). The routing kernel's
    timed cases are each held bit-equal as well.
    Returns (rows, the routing kernel's row)."""
    import torch

    from omni_avsr_tpu_torch.bridge import init_params
    from omni_avsr_tpu_torch.config import TrainConfig
    from omni_avsr_tpu_torch.ops.attention import FLASH_MIN_T_TRAIN
    from omni_avsr_tpu_torch.ops.audio_frontend import whisper_token_len
    from omni_avsr_tpu_torch.serve import Transcriber
    from omni_avsr_tpu_torch.train.engine import OmniEngine

    rows = {}
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = moe_model("balanced", "bucket")
    params = init_params(model.cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    server = Transcriber(model, params, device=DEV)
    torch.cuda.synchronize()
    n_moe = sum(int(v.numel()) for v in _tensor_leaves(params["llm"]["layers"]["moe"]))
    log("model", f"(o) the flagship with {MOE_EXPERTS} experts a layer: {n_moe / 1e9:.3f} B MoE "
        f"parameters (bf16, {n_moe * 2 / 1e9:.2f} GB), served unquantised, in "
        f"{time.perf_counter() - t:.1f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.1f} "
        f"GiB")
    L = model.cfg.llm.num_layers
    store = []
    with moe_routes(store, "kernel"):  # a first batch: its first call is the prefill's layer 0
        server.transcribe_many(items)
    checks = [route_summary("(o) first batch, every layer's prefill and decode steps", store)]
    prefill = store[0]
    del store
    rows["o"] = serve("(o) MoE 8 experts balanced bf16", server, items,
                      lambda s: counts(B1=L * s, MOE=L * (1 + s)))
    rel = decode_agreement(server, items[0])
    if rel > REL_L2_TOL:
        raise RuntimeError(f"(o) logits: kernel vs plain relative L2 {rel:.3g}")
    rows["o"]["decode_rel_l2"] = rel
    log("reference", f"(o) MoE balanced (B1, routing kernel): prefill + 2 decode steps, kernel "
        f"vs plain route: relative L2 logit difference {rel:.3g} (tol {REL_L2_TOL})")
    profile_batch("(o) MoE 8 experts balanced bf16", lambda: server.transcribe_many(items))
    server_top1 = Transcriber(moe_model("top1", "bucket"), params, device=DEV)
    rows["o top1"] = serve("(o) MoE 8 experts top1 bf16", server_top1, items,
                           lambda s: counts(B1=L * s), repeats=1)
    del server, server_top1
    torch.cuda.empty_cache()

    # training: (t)'s batch on the unfused three-task route
    model = moe_model("balanced", "pad30s")
    bank = (np.random.RandomState(1234).randn(10 * 16000) * 0.1).astype(np.float32)
    engine = OmniEngine(model, params, TrainConfig(lr=1e-3), noise_bank=bank, seed=0, device=DEV)
    del params
    engine.sample_rates = lambda: (4, 2)
    batch = train_batch(model.tok, B_TRAIN, FRAMES_TRAIN, TOKENS_TRAIN)
    trim = -(-int(whisper_token_len(FRAMES_TRAIN * 640)) // 25) * 25
    lengths = llm_lengths(model, trim, 4, 2, FRAMES_TRAIN, TOKENS_TRAIN)
    flash_tasks = [m for m, n in lengths.items() if n >= FLASH_MIN_T_TRAIN]
    fns = counters()
    times, losses, launches_each = [], [], []
    train_store = []
    for i in range(2):
        reset_counts(fns)
        t = time.perf_counter()
        with moe_routes(train_store, "kernel") if i == 0 else contextlib.nullcontext():
            loss = float(engine.train_step({**batch, "audio_trim_len": trim}))
        times.append(time.perf_counter() - t)
        launches = {name: fn.launches for name, fn in fns.items()}
        want = train_launches(model, len(flash_tasks), model.last_video_layers)
        if launches != want:
            raise RuntimeError(f"(o) train step: kernel launches {launches}, expected {want}")
        if not np.isfinite(loss):
            raise RuntimeError(f"(o) train step: loss {loss}")
        losses.append(loss)
        launches_each.append(launches)
    rows["o train"] = dict(config=f"(o) MoE train B {B_TRAIN} x {FRAMES_TRAIN} frames, pad30s",
                           s_per_step_each=times, losses=losses, launches=launches_each[-1],
                           llm_lengths=lengths,
                           peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log("train", json.dumps(rows["o train"]))
    checks.append(route_summary("(o) first train step, every layer, task and recompute",
                                train_store))
    rows["o train"]["grad_agreement"] = step_grad_agreement(
        engine, batch, trim, fns, "(o) MoE train step, B3/B4 and the routing kernel")
    del engine
    torch.cuda.empty_cache()

    scores, cap, _ = prefill
    cases = [moe_route_timing(flush, scores, cap, f"(o) prefill, {scores.shape[0]} rows"),
             moe_route_timing(flush, scores[:B_SERVE * K].contiguous(),
                              -(-B_SERVE * K // MOE_EXPERTS), "a decode step's 45 rows"),
             moe_route_timing(flush, train_store[0][0], train_store[0][1],
                              "(o) train step, audio task")]
    return rows, {**cases[0], "cases": cases, "real_logits": checks}


# ------------------------------------------- (g): the HTTP batching server

G_AV, G_AUDIO, G_FRAMES = 4, 3, 160  # (g)'s requests: 6.4 s each
# (g)'s batching window. The burst reaches the queue over ~0.2 s on the
# host (each audiovisual body is 6.4 MB, parsed in ~40 ms under the GIL, one
# after another), so a 200 ms window splits a group now and then; 1 s holds
# every request of the burst, and the groups are then its kinds alone.
G_WAIT_MS = 1000


def _request_body(item, modality=None) -> bytes:
    """A POST /transcribe body: base64 f32 audio, base64 uint8 video."""
    import base64

    body = {"audio_b64": base64.b64encode(item["audio"].tobytes()).decode()}
    if "video" in item:
        body["video_b64"] = base64.b64encode(item["video"].tobytes()).decode()
        body["video_shape"] = list(item["video"].shape)
    if modality:
        body["modality"] = modality
    return json.dumps(body).encode()


def _post(url: str, body: bytes, timeout: float = 600):
    """(status, JSON reply, wall s as the client sees it)."""
    import urllib.error
    import urllib.request

    t = time.perf_counter()
    req = urllib.request.Request(f"{url}/transcribe", data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), time.perf_counter() - t
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), time.perf_counter() - t


def http_phase(server, model):
    """(g): `cli/serve_http.py::serve` in front of (a)'s Transcriber (the 30
    s window, int8, beam 15, 32 tokens), `httpd.serve_forever` on a thread;
    eight client threads POST at once: 4 audiovisual requests of 160 frames
    (one bucket class), 3 audio-only ones of 6.4 s, and one that names
    "audiovisual" and carries no video (a 400). Every decoded batch has its
    launches counted (`transcribe_many` wrapped: counters set to 0 just
    before, read just after) and held to the count its modality and decode
    steps give; each 200's text must equal `transcribe_many` of the same
    batch called directly; /healthz must count 7 requests and 2 batches."""
    import threading
    import urllib.request

    import torch

    from omni_avsr_tpu_torch.cli.serve_http import serve as serve_http

    av = make_items([G_FRAMES] * G_AV, seed=7)
    audio = [{"audio": it["audio"]} for it in make_items([G_FRAMES] * G_AUDIO, seed=8)]
    bad = {"audio": make_items([G_FRAMES], seed=9)[0]["audio"]}
    sent = ([(it, _request_body(it)) for it in av] + [(it, _request_body(it)) for it in audio]
            + [(bad, _request_body(bad, "audiovisual"))])
    fns = counters()
    batches = []
    inner = server.transcribe_many

    def counted(items, **kw):
        reset_counts(fns)
        t = time.perf_counter()
        texts = inner(items, **kw)
        torch.cuda.synchronize()
        batches.append(dict(items=items, modality=kw["modality"], texts=texts,
                            s=time.perf_counter() - t, steps=server.last_decode_steps,
                            launches={name: fn.launches for name, fn in fns.items()}))
        return texts

    server.transcribe_many = counted  # the batcher's calls, counted one by one
    httpd, batcher = serve_http(server, port=0, max_batch=4, max_wait_ms=G_WAIT_MS)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    replies = [None] * len(sent)

    def client(i):
        replies[i] = _post(url, sent[i][1])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(sent))]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2**30
    with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
        health = json.loads(r.read())
    httpd.shutdown()
    batcher.shutdown()
    del server.transcribe_many

    if any(r is None for r in replies):
        raise RuntimeError(f"(g): a client got no reply: {replies}")
    codes = [r[0] for r in replies]
    if codes != [200] * (G_AV + G_AUDIO) + [400] or "requires" not in replies[-1][1]["error"]:
        raise RuntimeError(f"(g): replies {[(r[0], r[1]) for r in replies]}")
    sizes = [r[1]["batch_size"] for r in replies[:-1]]
    if sizes != [G_AV] * G_AV + [G_AUDIO] * G_AUDIO:
        raise RuntimeError(f"(g): batch sizes {sizes}")
    if health != {"ok": True, "requests": G_AV + G_AUDIO, "batches": 2} or len(batches) != 2:
        raise RuntimeError(f"(g): /healthz {health}, {len(batches)} decoded batches")
    rows = []
    for b in batches:
        frames = server.bucket_class(b["items"][0], b["modality"])[1] if "video" in b[
            "items"][0] else 0
        want = eval_launches(model, b["modality"], b["steps"], frames)
        if b["launches"] != want:
            raise RuntimeError(f"(g) {b['modality']} batch: kernel launches {b['launches']}, "
                               f"expected {want} for {b['steps']} decode steps")
        direct = server.transcribe_many(b["items"], modality=b["modality"])
        if direct != b["texts"] or not all(direct):
            raise RuntimeError(f"(g) {b['modality']}: served {b['texts']!r}, direct {direct!r}")
        rows.append(dict(modality=b["modality"], size=len(b["items"]), batch_s=b["s"],
                         decode_steps=b["steps"], video_frames=frames, launches=b["launches"]))
    for (item, _), (code, reply, _) in zip(sent[:-1], replies[:-1]):
        b = next(b for b in batches for it in b["items"]
                 if np.array_equal(it["audio"], item["audio"]))
        pos = next(i for i, it in enumerate(b["items"]) if np.array_equal(it["audio"],
                                                                         item["audio"]))
        if reply["text"] != b["texts"][pos]:
            raise RuntimeError(f"(g): reply {reply['text']!r}, batch text {b['texts'][pos]!r}")
    walls = [r[2] for r in replies[:-1]]
    audio_s = sum(len(it["audio"]) for it, _ in sent[:-1]) / 16000
    row = dict(config=f"(g) HTTP, pad30s int8 beam 15, max_batch 4, max_wait {G_WAIT_MS} ms, "
                      f"4 AV + 3 audio + 1 bad at once",
               request_s_median=float(np.median(walls)), request_s_max=max(walls),
               request_s_each=walls, bad_request_s=replies[-1][2], run_s=wall, audio_s=audio_s,
               audio_s_per_s=audio_s / wall, batches=rows, healthz=health, peak_gib=peak,
               launches=rows[0]["launches"])
    log("http", json.dumps(row))
    for b in batches:
        log("http", f"{b['modality']} batch of {len(b['items'])}: {b['texts'][0][:100]}")
    return row


# ---------------------------------- (h): the Llama-AVSR baseline, fused step

BASELINE_PROMPT = "Transcribe speech to text."  # the baseline CLIs' default prompt


def single_length(model, modality: str, ra, rv, trim: int, frames: int, token_len: int) -> int:
    """One rate combo's training sequence (`OmniAVSR._assemble_task`)."""
    n = 1 + len(model.prompt_ids[modality]) + token_len - 1
    if modality != "video":
        n += 2 + trim // ra
    if modality != "audio":
        n += 2 + frames // rv
    return n


def single_launches(model, modality: str, flash_combos: int, video_layers: int,
                    train: bool = True):
    """What one single-task step must launch: B3 in Whisper's layers (once:
    the engine encodes once for all the rate combos); in every AV-HuBERT
    layer that runs and every LLM layer of each combo whose sequence
    reaches the flash gate, B3 twice (training: the "dots" remat policy
    recomputes the layer in the backward) or once (evaluation) and
    (training) B4 once."""
    c = model.cfg
    use_a, use_v = modality != "video", modality != "audio"
    n = flash_combos * c.llm.num_layers
    again = 2 if train else 1
    return counts(B3=c.whisper.num_layers * use_a + again * (video_layers * use_v + n),
                  B4=(video_layers * use_v + n) if train else 0)


def baseline_phase():
    """(h): (t)'s batch (B 4 x 320 frames, 15-token transcripts, a babble
    bank) through the Llama-MTSK flagship (one prompt, a modality-agnostic
    LoRA, matryoshka): `single_train_step` on each modality, one warm and
    two measured steps, then one `single_eval_step`; then the task-specific
    flagship with `fused_task_forward=True` at rates (4, 2): one warm and two
    measured `train_step`s (B4 at B 12 in the fused backbone), and, in eval
    mode, its per-task losses and one step's grads against the unfused
    route on the same batch. Returns the rows."""
    import dataclasses

    import torch

    from omni_avsr_tpu_torch.bridge import init_params
    from omni_avsr_tpu_torch.config import TrainConfig
    from omni_avsr_tpu_torch.models.omni import OmniAVSR, flagship
    from omni_avsr_tpu_torch.ops.attention import FLASH_MIN_T_TRAIN
    from omni_avsr_tpu_torch.ops.audio_frontend import whisper_token_len
    from omni_avsr_tpu_torch.train.engine import OmniEngine
    from omni_avsr_tpu_torch.train.state import tree_leaves

    base = flagship(tiny=False)
    c = base.cfg
    cfg = dataclasses.replace(
        c, llm=dataclasses.replace(c.llm, lora=dataclasses.replace(c.llm.lora,
                                                                   task_specific=False)),
        is_task_specific=False, prompt_audio=BASELINE_PROMPT, prompt_video=BASELINE_PROMPT,
        prompt_audiovisual=BASELINE_PROMPT)
    model = OmniAVSR(cfg, base.tok)
    bank = (np.random.RandomState(1234).randn(10 * 16000) * 0.1).astype(np.float32)
    t = time.perf_counter()
    engine = OmniEngine(model, init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV),
                        TrainConfig(lr=1e-3), noise_bank=bank, seed=0, device=DEV)
    log("baseline", f"Llama-MTSK flagship on the card in {time.perf_counter() - t:.1f} s")
    batch = train_batch(model.tok, B_TRAIN, FRAMES_TRAIN, TOKENS_TRAIN)
    trim = -(-int(whisper_token_len(FRAMES_TRAIN * 640)) // 25) * 25
    batch["audio_trim_len"] = trim
    clip_s = B_TRAIN * FRAMES_TRAIN / 25.0
    fns = counters()
    rows = {}
    for modality in ("audio", "video", "audiovisual"):
        combos = engine._rate_combos(modality)
        lengths = [single_length(model, modality, ra, rv, trim, FRAMES_TRAIN, TOKENS_TRAIN)
                   for ra, rv in combos]
        flash = sum(n >= FLASH_MIN_T_TRAIN for n in lengths)
        t = time.perf_counter()
        warm = float(engine.single_train_step(dict(batch), modality))
        warm_s = time.perf_counter() - t
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses, launches_each = [], [], []
        for _ in range(2):
            reset_counts(fns)
            t = time.perf_counter()
            loss = float(engine.single_train_step(dict(batch), modality))  # a host sync
            times.append(time.perf_counter() - t)
            launches = {name: fn.launches for name, fn in fns.items()}
            want = single_launches(model, modality, flash, model.last_video_layers)
            if launches != want:
                raise RuntimeError(f"(h) {modality} single step: kernel launches {launches}, "
                                   f"expected {want} (combos {combos}, lengths {lengths}, "
                                   f"{model.last_video_layers} AV-HuBERT layers)")
            if not np.isfinite(loss):
                raise RuntimeError(f"(h) {modality} single step: loss {loss}")
            losses.append(loss)
            launches_each.append(launches)
        dt = float(np.median(times))
        rows[f"h {modality}"] = dict(
            config=f"(h) Llama-MTSK {modality}, B {B_TRAIN} x {FRAMES_TRAIN} frames, pad30s",
            rate_combos=combos, llm_lengths=lengths, flash_combos=flash, warm_s=warm_s,
            warm_loss=warm, s_per_step=dt, s_per_step_each=times, train_audio_s_per_s=clip_s / dt,
            losses=losses, launches=launches_each[-1], launches_each=launches_each,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        log("baseline", json.dumps(rows[f"h {modality}"]))
    lengths = [single_length(model, "audiovisual", ra, rv, trim, FRAMES_TRAIN, TOKENS_TRAIN)
               for ra, rv in engine._rate_combos("audiovisual")]
    reset_counts(fns)
    t = time.perf_counter()
    ev = float(engine.single_eval_step(dict(batch), "audiovisual"))
    ev_s = time.perf_counter() - t
    launches = {name: fn.launches for name, fn in fns.items()}
    want = single_launches(model, "audiovisual", sum(n >= FLASH_MIN_T_TRAIN for n in lengths),
                           c.avhubert.encoder_layers, train=False)
    if launches != want or not np.isfinite(ev):
        raise RuntimeError(f"(h) single_eval_step: loss {ev}, kernel launches {launches}, "
                           f"expected {want}")
    rows["h eval"] = dict(config="(h) Llama-MTSK single_eval_step audiovisual", loss=ev,
                          s=ev_s, launches=launches)
    log("baseline", json.dumps(rows["h eval"]))
    del engine
    torch.cuda.empty_cache()

    # the task-specific flagship, the three tasks in one stacked forward
    fused = OmniAVSR(dataclasses.replace(c, fused_task_forward=True), base.tok)
    engine = OmniEngine(fused, init_params(c, torch.Generator(device=DEV).manual_seed(0), DEV),
                        TrainConfig(lr=1e-3), noise_bank=bank, seed=0, device=DEV)
    engine.sample_rates = lambda: (4, 2)
    lengths = llm_lengths(fused, trim, 4, 2, FRAMES_TRAIN, TOKENS_TRAIN)
    t_max = max(lengths.values())
    t = time.perf_counter()
    warm = float(engine.train_step(dict(batch)))
    warm_s = time.perf_counter() - t
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses, launches_each = [], [], []
    for _ in range(2):
        reset_counts(fns)
        t = time.perf_counter()
        loss = float(engine.train_step(dict(batch)))
        times.append(time.perf_counter() - t)
        launches = {name: fn.launches for name, fn in fns.items()}
        want = train_launches(fused, int(t_max >= FLASH_MIN_T_TRAIN), fused.last_video_layers)
        if launches != want or not np.isfinite(loss):
            raise RuntimeError(f"(h) fused train step: loss {loss}, kernel launches {launches}, "
                               f"expected {want} (T_max {t_max})")
        losses.append(loss)
        launches_each.append(launches)
    dt = float(np.median(times))
    rows["h fused"] = dict(
        config=f"(h) fused three-task step, B {B_TRAIN} x {FRAMES_TRAIN} frames, pad30s, rates "
               f"(4, 2)", llm_lengths=lengths, backbone=[3 * B_TRAIN, t_max], warm_s=warm_s,
        warm_loss=warm, s_per_step=dt, s_per_step_each=times, train_audio_s_per_s=clip_s / dt,
        losses=losses, launches=launches_each[-1], launches_each=launches_each,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log("baseline", json.dumps(rows["h fused"]))

    # eval mode, the same batch and masters: fused against unfused
    unfused = OmniAVSR(c, base.tok)
    arrays, trim_len = engine._arrays(dict(batch))
    proc = engine._preprocess(arrays, train=False)
    leaves = list(tree_leaves(engine.state.trainable))
    result = {}
    for name, m in (("fused", fused), ("unfused", unfused)):
        reset_counts(fns)
        losses = m.train_losses(engine._params(), proc, 4, 2, trim_len, train_mode=False)
        total = (losses["audio"] + losses["video"] + losses["audiovisual"]) / 3.0
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        flat = torch.cat([(torch.zeros_like(p) if g is None else g).float().reshape(-1)
                          for p, g in zip(leaves, grads)])
        used = {k: fn.launches for k, fn in fns.items()}
        if used != train_launches(m, 1, c.avhubert.encoder_layers):
            raise RuntimeError(f"(h) {name} eval-mode step: kernel launches {used}")
        result[name] = ({k: v.item() for k, v in losses.items()}, flat)
    (lf, gf), (lu, gu) = result["fused"], result["unfused"]
    rel = ((gf - gu).norm() / gu.norm()).item()
    if (rel > REL_L2_TOL or not bool(torch.isfinite(gf).all())
            or any(abs(lf[k] - lu[k]) > REL_L2_TOL * abs(lu[k]) for k in lu)):
        raise RuntimeError(f"(h) fused vs unfused: losses {lf} vs {lu}, grads relative L2 "
                           f"{rel:.3g}")
    agree = dict(losses_fused=lf, losses_unfused=lu, grad_rel_l2=rel, grad_norm=gu.norm().item())
    log("reference", f"(h) one full-width batch in eval mode, fused vs unfused route: "
        f"{json.dumps(agree)} (tol {REL_L2_TOL})")
    rows["h fused"]["agreement"] = agree
    del engine, leaves, result, gf, gu
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------- (i): a raw clip, end to end

# LRS3's raw crop size and the golden clip's shape (tests/test_golden_clip.py:21)
RAW_T, RAW_HW = 155, 224
RAW_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_raw"
DET_CPU_FRAMES = 8  # frames the card's detector is held against the CPU on


def raw_clip(root: Path, name: str, frames: int, seed: int) -> Path:
    """A raw clip as the card's machine reads one: `.npy` frames (T, 224,
    224, 3) uint8 RGB (a moving pattern plus noise) and a sibling 16 kHz
    wav of 640 samples per frame, from `seed`."""
    from omni_avsr_tpu_torch.data.synthetic import _write_wav

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:RAW_HW, 0:RAW_HW].astype(np.float32)
    t = np.arange(frames, dtype=np.float32)[:, None, None]
    base = 127 + 80 * np.sin(xx / 13 + t * 0.2) * np.cos(yy / 17 - t * 0.1)
    video = base[..., None] + rng.randn(frames, RAW_HW, RAW_HW, 3).astype(np.float32) * 6
    path = root / f"{name}.npy"
    np.save(path, np.clip(video, 0, 255).astype(np.uint8))
    _write_wav(str(root / f"{name}.wav"), (rng.randn(frames * 640) * 0.1).astype(np.float32))
    return path


def rel_l2(a, b) -> float:
    import torch

    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def raw_transcribe(server, clip: Path, expected):
    """`transcribe_file(clip, preprocessed=False, detector="center")`: one
    warm call, then one with every counter set to 0 just before and read
    just after, held to `expected(steps)`."""
    import torch

    server.transcribe_file(str(clip), detector="center")
    torch.cuda.synchronize()
    fns = counters()
    reset_counts(fns)
    t = time.perf_counter()
    text = server.transcribe_file(str(clip), detector="center")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = {name: fn.launches for name, fn in fns.items()}
    want = expected(server.last_decode_steps)
    if launches != want:
        raise RuntimeError(f"(i) transcribe_file: kernel launches {launches}, expected {want} "
                           f"for {server.last_decode_steps} decode steps")
    if not isinstance(text, str) or not text:
        raise RuntimeError(f"(i) transcribe_file: an empty transcript {text!r}")
    row = dict(config="(i) raw clip, center detector, pad30s int8", frames=RAW_T,
               frame_hw=RAW_HW, audio_s=RAW_T * 640 / 16000, s_per_clip=dt,
               stages_s=server.last_file_seconds, decode_steps=server.last_decode_steps,
               launches=launches, transcript=text)
    log("raw", json.dumps(row))
    return row


def detector_phase(clip: Path):
    """RetinaFace-ResNet50 and FAN (2 hourglass modules) at full width on
    the card: the trees of `init_retinaface(0)` and `init_fan(0)` (face
    class +6, box head x 1e-3, tests/test_detector_models.py:349-353),
    saved as state dicts in the public layouts and loaded back through
    `TorchLandmarksDetector(path, path)`; the clip's frames through it (one
    warm call, one timed), each stage per frame, and the networks alone.
    Then the same modules on the CPU in f32 on the first 8 frames: conf,
    loc and the FAN heatmaps (of crops of a centered face box) by relative
    L2 (tol 2e-2), the faces after NMS equal in count per frame, and the
    share of landmarks within 0.5 px. The random-weight landmarks are not
    fed to the ROI tail: their warped mouth may rightly hit `cut_patch`'s
    OverflowError."""
    import torch

    from omni_avsr_tpu_torch.convert.detector_torch import (
        fan_state_dict,
        init_fan,
        init_retinaface,
        retinaface_state_dict,
    )
    from omni_avsr_tpu_torch.preprocess import fan as fan_mod
    from omni_avsr_tpu_torch.preprocess import retinaface as rf_mod
    from omni_avsr_tpu_torch.preprocess.detector import (
        TorchLandmarksDetector,
        largest_face_index,
    )

    rf, fan = init_retinaface(0), init_fan(0)
    for h in rf["class_head"]:
        h["b"][1::2] += 6.0
    for h in rf["bbox_head"]:
        h["w"] *= 1e-3
    paths = RAW_DIR / "Resnet50_Final.pth", RAW_DIR / "fan.pth"
    for path, sd in zip(paths, (retinaface_state_dict(rf), fan_state_dict(fan))):
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    det = TorchLandmarksDetector(str(paths[0]), str(paths[1]), device=DEV)
    frames = np.load(clip)
    T = len(frames)
    det(frames)  # first use of the networks' shapes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fns = counters()
    reset_counts(fns)
    t = time.perf_counter()
    lms = det(frames)
    torch.cuda.synchronize()
    total = time.perf_counter() - t
    launches = {name: fn.launches for name, fn in fns.items()}  # none: cuDNN convs
    peak = torch.cuda.max_memory_allocated() / 2**30
    found = sum(lm is not None for lm in lms)
    if found != T or not all(np.isfinite(lm).all() and lm.shape == (68, 2) for lm in lms):
        raise RuntimeError(f"(i) detector: landmarks for {found} of {T} frames")

    # each stage alone over the clip: the networks, the host's box decode and
    # NMS, the crops, the heatmap decode
    x = torch.as_tensor(frames, device=DEV)
    mean = torch.tensor(rf_mod.MEAN_BGR, device=DEV)
    B = det.batch
    priors = rf_mod.priors_for(RAW_HW, RAW_HW)

    def rf_net():
        with torch.inference_mode():
            return [rf_mod.retinaface_forward(det.rf, x[i:i + B].float() - mean)
                    for i in range(0, T, B)]

    outs = rf_net()
    loc = torch.cat([o[0] for o in outs]).cpu().numpy()
    scores = torch.cat([o[1][..., 1] for o in outs]).cpu().numpy()

    def box_decode():
        return [rf_mod.frame_faces(loc[b], scores[b], priors, RAW_HW, RAW_HW, det.threshold)
                for b in range(T)]

    faces = box_decode()
    boxes = np.stack([f[largest_face_index(f)][:4] for f in faces])
    rgb = x.flip(-1)

    def crops():
        return [fan_mod.crop_faces(rgb[i:i + B], boxes[i:i + B]) for i in range(0, T, B)]

    cropped = crops()

    def fan_net():
        with torch.inference_mode():
            return [fan_mod.fan_forward(det.fan, c[0]) for c in cropped]

    heatmaps = fan_net()

    def heatmap_decode():
        return [fan_mod.heatmaps_to_landmarks(h, c[1], c[2]) for h, c in zip(heatmaps, cropped)]

    ms = {name: host_ms(fn, iters=3) for name, fn in
          (("retinaface_net_ms", rf_net), ("box_decode_nms_ms", box_decode), ("crop_ms", crops),
           ("fan_net_ms", fan_net), ("heatmap_decode_ms", heatmap_decode))}
    per_frame = {**{k: v / T for k, v in ms.items()}, "detector_ms": total * 1e3 / T}

    # the same modules on the CPU, f32, on the first frames
    n = DET_CPU_FRAMES
    rf_cpu, fan_cpu = rf_mod.conv_layout(rf, "cpu"), rf_mod.conv_layout(fan, "cpu")
    xin = torch.as_tensor(frames[:n]).float() - torch.tensor(rf_mod.MEAN_BGR)
    with torch.inference_mode():
        loc_d, conf_d, _ = rf_mod.retinaface_forward(det.rf, xin.to(DEV))
        loc_h, conf_h, _ = rf_mod.retinaface_forward(rf_cpu, xin)
        faces_h = rf_mod.detect_faces(rf_cpu, torch.as_tensor(frames[:n]))
        # FAN on crops of a centered face box (80% of the frame): with random
        # weights the largest detected box is far larger than the frame, and
        # its crop holds no pixel of it
        side = 0.8 * RAW_HW
        centered = np.array([[(RAW_HW - side) / 2 + i, (RAW_HW - side) / 2,
                              (RAW_HW + side) / 2 + i, (RAW_HW + side) / 2] for i in range(n)],
                            np.float32)
        crops_h, _, _ = fan_mod.crop_faces(torch.as_tensor(frames[:n]).flip(-1), centered)
        hm_d = fan_mod.fan_forward(det.fan, crops_h.to(DEV))
        hm_h = fan_mod.fan_forward(fan_cpu, crops_h)
    agree = dict(conf_rel_l2=rel_l2(conf_d, conf_h), loc_rel_l2=rel_l2(loc_d, loc_h),
                 heatmap_rel_l2=rel_l2(hm_d, hm_h))
    bad = {k: v for k, v in agree.items() if not v <= REL_L2_TOL}
    if bad:
        raise RuntimeError(f"(i) detector on the card vs the CPU: {bad} (tol {REL_L2_TOL})")
    counts_d, counts_h = [len(f) for f in faces[:n]], [len(f) for f in faces_h]
    if counts_d != counts_h:
        raise RuntimeError(f"(i) faces after NMS: card {counts_d}, CPU {counts_h}")
    lms_h = TorchLandmarksDetector(rf, fan, device="cpu")(frames[:n])
    dist = np.stack([np.linalg.norm(a - b, axis=-1) for a, b in zip(lms[:n], lms_h)])
    row = dict(config="(i) RetinaFace-ResNet50 + FAN (2 modules), random weights via .pth",
               frames=T, frame_hw=RAW_HW, batch=det.batch, clip_s=total, per_frame_ms=per_frame,
               launches=launches,
               peak_gib=peak, cpu_check_frames=n, **agree, faces_after_nms=counts_d,
               landmarks_within_half_px=float((dist <= 0.5).mean()),
               landmark_max_px=float(dist.max()),
               cudnn_math=("TF32" if torch.backends.cudnn.allow_tf32 else "f32 (TF32 off)"),
               channels_last=bool(det.rf["body"]["stem"]["w"].is_contiguous(
                   memory_format=torch.channels_last)))
    log("raw", json.dumps(row))
    return row


def raw_phase(server, expected):
    """(i): a raw clip (155 frames of 224x224x3 and 6.2 s of audio, from a
    seed) through `Transcriber.transcribe_file` on (a)'s server, then the
    full-width detectors over it (`detector_phase`). Returns the rows and
    the clip, which the CLI phase reads too."""
    import shutil

    shutil.rmtree(RAW_DIR, ignore_errors=True)
    RAW_DIR.mkdir(parents=True)
    clip = raw_clip(RAW_DIR, "clip", RAW_T, seed=155)
    rows = {"i": raw_transcribe(server, clip, expected), "i detector": detector_phase(clip)}
    return rows, clip


# ----------------------------------- (j): the reference profile, serving

REF_PROFILE_SERVE = dict(attn_route="xla", select_mode="grid")  # OMNI_PROFILE=reference


def route_agreement(t, item, steps: int = 2) -> float:
    """The prefill and the first decode steps of the full-width LLM on the
    kernel route (the ancestor cache, B1) and on the reorder route (the
    split cache gathered by parent every step, the three-block softmax in
    torch ops), on one tree and one prefix, the kernel route's tokens fed
    to both and the same parents each step. Returns the largest relative
    L2 logit difference."""
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
        for route in ("kernel", "xla"):
            cache0 = llm_mod.KVCache.create(cfg, 1, Pp, dtype=model.dtype, device=DEV)
            lg, cache0 = llm_mod.llm_prefill_masked(llm, cfg, prefix, valid, positions, last,
                                                    cache0, "audiovisual", layers=layers)
            out = [lg]
            if route == "kernel":
                cache = llm_mod.AncSplitCache.from_prefill(cache0, Pp, K, N)
                anc = torch.arange(K, dtype=torch.int32, device=DEV)[None, :, None].expand(
                    1, K, N).contiguous()
                tokens.append(torch.topk(lg[0], K).indices)
            else:
                cache = llm_mod.SplitCache.from_prefill(cache0, Pp, K, N)
            for step in range(steps):
                flat_idx = torch.roll(torch.arange(K, device=DEV), step)  # exercise ancestry
                emb = llm_mod.embed_tokens(llm, tokens[step][:, None], model.dtype)
                if route == "kernel":
                    anc = llm_mod.update_ancestors(anc, flat_idx, step, K)
                    lg, cache = llm_mod.llm_decode_step_beam_anc(
                        llm, cfg, emb, step, n_valid, valid, cache, anc, K, "audiovisual",
                        layers=layers)
                    tokens.append(lg.argmax(dim=-1))
                else:
                    lg, cache = llm_mod.llm_decode_step_beam(
                        llm, cfg, emb, step, n_valid, valid, cache.reorder_(flat_idx), K,
                        "audiovisual", layers=layers)
                out.append(lg)
            logits[route] = out
    worst = 0.0
    for a, b in zip(logits["xla"], logits["kernel"]):
        if not bool(torch.isfinite(a).all()):
            raise RuntimeError("non-finite logits on the reorder route")
        worst = max(worst, ((a - b).norm() / b.norm()).item())
    return worst


def reorder_and_grid_ms(cfg, B: int, P: int) -> dict:
    """Device time of one beam step's torch-op pieces of the reference
    profile at serving shapes: the reorder gather of the split cache's
    generated K and V ((B*15, L, Hkv, 32, D) bf16 each), the grid
    selection's top-2K over the (B, 15 * V) log-probabilities, and one
    layer's three-block attention; each beside its bound (bytes moved)."""
    import torch

    import omni_avsr_tpu_torch.models.llm as llm_mod
    from omni_avsr_tpu_torch.decode.decoding import top_k

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    L, H, D_ = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    gen = torch.randn(B * K, L, H, N, D_, device=DEV).to(torch.bfloat16)
    cache = llm_mod.SplitCache(torch.zeros(L, B, H, P, D_, device=DEV, dtype=torch.bfloat16),
                               torch.zeros(L, B, H, P, D_, device=DEV, dtype=torch.bfloat16),
                               gen, gen.clone())
    flat_idx = torch.randint(0, B * K, (B * K,), device=DEV)
    gather = time_ms(lambda: cache.reorder_(flat_idx), flush, iters=20)
    gather_bound, _ = bound_ms(2 * 2 * gen.numel() * 2, 0)
    grid = torch.randn(B, K * cfg.vocab_size, device=DEV)
    topk = time_ms(lambda: top_k(grid, 2 * K), flush, iters=20)
    topk_bound, _ = bound_ms(grid.numel() * 4, 0)
    q = torch.randn(B * K, 1, cfg.num_heads, D_, device=DEV).to(torch.bfloat16)
    pk = torch.randn(B, H, P, D_, device=DEV).to(torch.bfloat16)
    gk = torch.randn(B * K, H, N, D_, device=DEV).to(torch.bfloat16)
    cur = torch.randn(B * K, H, D_, device=DEV).to(torch.bfloat16)
    pmask = torch.ones(B, P, dtype=torch.bool, device=DEV)
    gmask = torch.arange(N, device=DEV) < N // 2
    attn = time_ms(lambda: llm_mod.merged_beam_attention(q, pk, pk, gk, gk, cur, cur, pmask,
                                                         gmask, K), flush, iters=20)
    attn_bound, _ = bound_ms(2 * (pk.numel() + gk.numel()) * 2, 0)
    del flush, gen, cache, grid
    torch.cuda.empty_cache()
    return dict(reorder_gather_ms=gather, reorder_gather_bound_ms=gather_bound,
                grid_topk_ms=topk, grid_topk_bound_ms=topk_bound,
                merged_attention_layer_ms=attn, merged_attention_bound_ms=attn_bound,
                shapes=dict(B=B, beams=K, layers=L, kv_heads=H, new=N, D=D_, P=P,
                            vocab=cfg.vocab_size))


def reference_serving_phase(model_a, items_a, model_b, items_b):
    """(j): (a)'s three requests on the full-width flagship in bf16 weights
    (the reference profile's configuration: no quantisation), beam 15, 32
    new tokens, on the reorder route with grid selection
    (`attn_route="xla", select_mode="grid"`): one warm and one measured
    batch, B3 48 and no other launch; the reorder route held against the
    kernel route on the same tree; the device time of its reorder gather
    and grid top-k per step; then one (b) batch with
    `no_repeat_ngram_size=2` on the kernel route, where no output may
    repeat a bigram. Returns the rows."""
    import torch

    from omni_avsr_tpu_torch.bridge import init_params
    from omni_avsr_tpu_torch.serve import Transcriber, pad_batch

    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(model_a.cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    server = Transcriber(model_a, params, device=DEV, **REF_PROFILE_SERVE)
    log("reference", f"(j) bf16 flagship tree on the card in {time.perf_counter() - t:.1f} s")
    tower_b3 = model_a.cfg.whisper.num_layers + model_a.cfg.avhubert.encoder_layers
    rows = {"j": serve("(j) pad30s bf16 reorder route + grid", server, items_a,
                       lambda s: counts(B3=tower_b3), repeats=1)}
    rel = route_agreement(server, items_a[0])
    if rel > REL_L2_TOL:
        raise RuntimeError(f"(j) reorder vs kernel route: relative L2 {rel:.3g}")
    log("reference", f"(j) bf16 tree, prefill + 2 decode steps, reorder route vs kernel route "
        f"(B1): relative L2 logit difference {rel:.3g} (tol {REL_L2_TOL})")
    rows["j"]["route_rel_l2"] = rel
    batch_a, trim_a = pad_batch(items_a, "audiovisual")
    P_a = model_a.prefix_slots("audiovisual", 4, 2, trim_a, batch_a["video"].shape[1])
    pieces = reorder_and_grid_ms(model_a.cfg.llm, len(items_a), P_a)
    rows["j"]["per_step_torch_ops"] = pieces
    log("reference", f"(j) per beam step at serving shapes: {json.dumps(pieces)}")

    # the n-gram ban on the kernel route, (b)'s batch on the bf16 tree
    server_b = Transcriber(model_b, params, device=DEV, attn_route="kernel",
                           no_repeat_ngram_size=2)
    del params
    layers = model_b.cfg.llm.num_layers
    rows["j ngram"] = serve("(j) bucket bf16 kernel route, no_repeat_ngram_size 2", server_b,
                            items_b, lambda s: counts(B1=layers * s), repeats=1)
    batch, trim = pad_batch(items_b, "audiovisual")
    ids = server_b.decode_ids(batch, "audiovisual", 4, 2, trim, K).cpu().tolist()
    pad = model_b.tok.pad_id
    for row in ids:
        toks = [tok for tok in row if tok != pad]
        grams = [tuple(toks[i:i + 2]) for i in range(len(toks) - 1)]
        if len(grams) != len(set(grams)):
            raise RuntimeError(f"(j) no_repeat_ngram_size 2: a repeated bigram in {toks}")
    rows["j ngram"]["ids"] = ids
    log("reference", f"(j) n-gram ban: {len(ids)} outputs, no repeated bigram")
    del server, server_b
    torch.cuda.empty_cache()
    return rows


# ---------------------------------- (k): the reference profile, training

REMAT_POLICIES = ("off", "dots", "full")


def reference_train_phase():
    """(k): (t)'s batch (B 4 x 320 frames, 30 s window, babble bank, rates
    (4, 2)) through `OmniEngine(prng="threefry", bn_stats="twopass",
    augment=True)` at remat "off", "dots" and "full": one step each from
    the same masters and the same key (a fresh engine each, seed 0), each
    step's launches held to the count its policy gives, s/step and peak
    memory, the three losses within 1e-5 relative, and a second "dots"
    engine's loss bit-equal to the first's. Returns the row."""
    import torch

    from omni_avsr_tpu_torch.bridge import init_params
    from omni_avsr_tpu_torch.config import TrainConfig
    from omni_avsr_tpu_torch.models.omni import flagship
    from omni_avsr_tpu_torch.ops.attention import FLASH_MIN_T_TRAIN
    from omni_avsr_tpu_torch.ops.audio_frontend import whisper_token_len
    from omni_avsr_tpu_torch.train.engine import OmniEngine

    model = flagship(tiny=False)
    params = init_params(model.cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    bank = (np.random.RandomState(1234).randn(10 * 16000) * 0.1).astype(np.float32)
    batch = train_batch(model.tok, B_TRAIN, FRAMES_TRAIN, TOKENS_TRAIN)
    trim = -(-int(whisper_token_len(FRAMES_TRAIN * 640)) // 25) * 25
    lengths = llm_lengths(model, trim, 4, 2, FRAMES_TRAIN, TOKENS_TRAIN)
    flash = sum(n >= FLASH_MIN_T_TRAIN for n in lengths.values())
    fns = counters()
    rows = {}
    for label, policy in [(p, p) for p in REMAT_POLICIES] + [("dots again", "dots")]:
        engine = OmniEngine(model, params, TrainConfig(lr=1e-3), noise_bank=bank, seed=0,
                            device=DEV, prng="threefry", bn_stats="twopass", remat=policy)
        engine.sample_rates = lambda: (4, 2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fns)
        t = time.perf_counter()
        loss = float(engine.train_step({**batch, "audio_trim_len": trim}))  # a host sync
        dt = time.perf_counter() - t
        launches = {name: fn.launches for name, fn in fns.items()}
        want = train_launches(model, flash, model.last_video_layers, remat=policy)
        if launches != want or not np.isfinite(loss):
            raise RuntimeError(f"(k) remat {policy}: loss {loss}, kernel launches {launches}, "
                               f"expected {want} ({model.last_video_layers} AV-HuBERT layers)")
        rows[label] = dict(remat=policy, loss=loss, step_s=dt, launches=launches,
                           avhubert_layers_run=model.last_video_layers,
                           peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        log("reference", f"(k) threefry, twopass BN, remat {label}: {json.dumps(rows[label])}")
        del engine
        torch.cuda.empty_cache()
    del params
    base = rows["off"]["loss"]
    for policy in ("dots", "full"):
        if abs(rows[policy]["loss"] - base) > 1e-5 * abs(base):
            raise RuntimeError(f"(k) remat {policy} loss {rows[policy]['loss']} vs off {base}")
    if rows["dots again"]["loss"] != rows["dots"]["loss"]:
        raise RuntimeError(f"(k) two threefry steps from one seed: {rows['dots']['loss']} vs "
                           f"{rows['dots again']['loss']}")
    row = dict(config=f"(k) train B {B_TRAIN} x {FRAMES_TRAIN} frames, pad30s, threefry, "
                      f"twopass BN, augment", by_remat=rows, llm_lengths=lengths,
               launches=rows["dots"]["launches"])
    log("reference", f"(k) the three losses agree within 1e-5 relative; two runs of the step "
        f"from one seed give bit-equal losses ({rows['dots']['loss']!r})")
    return row


THREEFRY_SHAPE = (B_TRAIN, FRAMES_TRAIN, 1024)  # AV-HuBERT's dropout shape in (k)


def threefry_check() -> dict:
    """The threefry draws of `utils/prng.py` on the card and on the CPU at
    AV-HuBERT's dropout shape in (k), bit-equal (the arithmetic is integer
    arithmetic), with the device time of each draw."""
    import torch

    from omni_avsr_tpu_torch.utils import prng

    key = prng.split(prng.PRNGKey(20261018), 3)[2]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    draws = {"random_bits": lambda d: prng.random_bits(key, THREEFRY_SHAPE, d),
             "uniform": lambda d: prng.uniform(key, THREEFRY_SHAPE, d),
             "bernoulli": lambda d: prng.bernoulli(key, 0.9, THREEFRY_SHAPE, d),
             "randint": lambda d: prng.randint(key, THREEFRY_SHAPE, 0, 2**31 - 1, d)}
    row = dict(shape=list(THREEFRY_SHAPE))
    for name, draw in draws.items():
        card, host = draw(DEV), draw("cpu")
        if card.dtype == torch.float32:
            card, host = card.view(torch.int32), host.view(torch.int32)
        if not torch.equal(card.cpu(), host):
            raise RuntimeError(f"threefry {name}: the card's bits differ from the CPU's")
        row[f"{name}_ms"] = time_ms(lambda: draw(DEV), flush, iters=10)
    log("threefry", f"card == CPU bit for bit: {json.dumps(row)}")
    return row


# ------------------------------- (l), (m): the AV-HuBERT family at full width

S2S_TOKENS, S2S_BEAMS = 64, 15  # (l)'s target length, decode length and beams


def av_clips(B: int, frames: int, seed: int):
    """B clips of `frames` raw 96x96 RGB frames with their 16 kHz waveforms
    (640 samples per frame), from numpy."""
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 255, (B, frames, 96, 96, 3)).astype(np.uint8),
            (rng.randn(B, frames * 640) * 0.05).astype(np.float32))


def launches_now(fns) -> dict:
    return {name: fn.launches for name, fn in fns.items()}


def family_steps(label: str, step, n: int, want, fns):
    """One warm call of `step(i)` (a loss) and n measured ones, each call's
    launches held to `want`; (s per call, losses, launches)."""
    import torch

    times, losses = [], []
    for i in range(n + 1):
        torch.cuda.synchronize()
        reset_counts(fns)
        t = time.perf_counter()
        loss = float(step(i))  # a host sync: the step has ended on the device
        dt = time.perf_counter() - t
        launches = launches_now(fns)
        if launches != want or not np.isfinite(loss):
            raise RuntimeError(f"{label}: loss {loss}, kernel launches {launches}, expected {want}")
        if i:
            times.append(dt)
            losses.append(loss)
    return times, losses, launches


GRAD_FLOOR_MARGIN = 1.25  # the kernel route's error over the bf16 plain route's, at most


def route_grads(label: str, loss_and_grads, fns) -> dict:
    """One step's loss and grads of every master leaf, the same draws,
    three ways: in bf16 through B3/B4, in bf16 through their plain versions,
    and in f32 through the plain versions, the reference. A step that
    trains the whole encoder and decoder carries the bf16 rounding of every
    layer into every grad (the decoder's, which no kernel touches, move as
    much as the encoder's), ~3% relative L2 against the f32 step, above
    REL_L2_TOL; so the kernels are held to add no error of their own: the
    kernel route's distance to the f32 grads at most GRAD_FLOOR_MARGIN times
    the plain bf16 route's, and the two bf16 losses within REL_L2_TOL.
    `loss_and_grads(dtype)` returns (loss, grads) in that compute dtype."""
    import torch

    result = {}
    for route, dtype in (("kernel", torch.bfloat16), ("plain", torch.bfloat16),
                         ("plain f32", torch.float32)):
        with plain_train_route() if route != "kernel" else contextlib.nullcontext():
            reset_counts(fns)
            loss, grads = loss_and_grads(dtype)
            check_route_launches("plain" if route != "kernel" else route, launches_now(fns))
            result[route] = (float(loss), torch.cat([g.float().reshape(-1) for g in grads]))
            del grads
    (lk, gk), (lp, gp), (lf, gf) = result["kernel"], result["plain"], result["plain f32"]
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    agree = dict(loss_kernel=lk, loss_plain=lp, loss_f32=lf, grad_rel_l2=rel(gk, gp),
                 kernel_vs_f32=rel(gk, gf), plain_vs_f32=rel(gp, gf), grad_norm=gf.norm().item())
    if not (np.isfinite(lk) and bool(torch.isfinite(gk).all())):
        raise RuntimeError(f"{label}: non-finite loss or grads on the kernel route")
    if (agree["kernel_vs_f32"] > GRAD_FLOOR_MARGIN * agree["plain_vs_f32"]
            or abs(lk - lp) > REL_L2_TOL * abs(lp)):
        raise RuntimeError(f"{label}, kernel vs plain vs f32: {json.dumps(agree)}")
    log("reference", f"{label}, B3/B4 vs plain (bf16) vs plain f32, same draws: "
        f"{json.dumps(agree)} (kernel_vs_f32 <= {GRAD_FLOOR_MARGIN} x plain_vs_f32; bf16 "
        f"losses within {REL_L2_TOL})")
    return agree


def s2s_phase(enc_cfg=None, dec_cfg=None, B: int = B_TRAIN, frames: int = FRAMES_TRAIN):
    """(l): AV-HuBERT Large (no LoRA) with the seq2seq decoder of
    `S2SDecoderConfig()` (6 post-LN layers of 768, FFN 3072, 4 heads at 192,
    1000 tokens, tied embedding) and with the CTC head, random weights from a
    seed, B clips of `frames` frames, audiovisual (the stacked filterbanks
    of each clip's waveform): `train_avhubert_s2s`'s step (`S2STrainer`,
    bf16 compute on f32 masters, threefry keys) for the s2s head under remat
    "dots" (B3 2 x 24, B4 24 a step), the CTC head under "off" (B3 24, B4
    24) and the s2s head with `--freeze-encoder` (B3 24, B4 0; every encoder
    master bit-equal after the step), 64-token targets; one s2s step's loss
    and grads on the kernel and on the plain route; then
    `eval_avhubert_s2s`'s decode in bf16: greedy and beam 15 at max_len 64
    (B3 24 a batch), and the first two decode steps' logits on both
    routes (EOS's embedding row zeroed, so that the decodes of random
    weights run all 64 steps). Returns the rows."""
    import torch

    from omni_avsr_tpu_torch.bridge import init_avhubert, init_ctc_head, init_s2s_decoder
    from omni_avsr_tpu_torch.cli.train_avhubert_s2s import S2STrainer
    from omni_avsr_tpu_torch.config import avhubert_large
    from omni_avsr_tpu_torch.data.audio_features import batch_stacked_fbank
    from omni_avsr_tpu_torch.models.avhubert import avhubert_encode
    from omni_avsr_tpu_torch.models.avhubert_s2s import (
        S2SDecoderConfig,
        _decode_setup,
        _s2s_decode_step,
        s2s_beam_decode,
        s2s_greedy_decode,
    )
    from omni_avsr_tpu_torch.ops.augment import video_pipeline
    from omni_avsr_tpu_torch.train.state import tree_map
    from omni_avsr_tpu_torch.utils import prng

    enc_cfg = enc_cfg or avhubert_large(use_lora=False)
    dec_cfg = dec_cfg or S2SDecoderConfig()
    L = enc_cfg.encoder_layers
    t = time.perf_counter()
    video_np, audio_np = av_clips(B, frames, seed=5)
    afe = batch_stacked_fbank(audio_np, np.full(B, frames * 640), frames)
    fbank_s = time.perf_counter() - t
    video = torch.from_numpy(video_np).to(DEV)
    afeats = torch.from_numpy(afe).to(DEV)
    video_len = torch.full((B,), frames, dtype=torch.int32, device=DEV)
    rng = np.random.RandomState(6)
    tgt_np = rng.randint(4, dec_cfg.vocab_size, (B, S2S_TOKENS)).astype(np.int32)
    tgt_np[:, -1] = dec_cfg.eos_id
    tgt = torch.from_numpy(tgt_np).to(DEV)
    tgt_len = torch.full((B,), S2S_TOKENS, dtype=torch.int32, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    enc = init_avhubert(enc_cfg, gen, DEV)
    heads = {"s2s": init_s2s_decoder(dec_cfg, gen, DEV),
             "ctc": init_ctc_head(enc_cfg.encoder_embed_dim, dec_cfg.vocab_size, gen, DEV)}
    key = prng.PRNGKey(17)
    fns = counters()
    clip_s = B * frames / 25.0
    rows = {}
    log("s2s", f"(l) AV-HuBERT Large, {L} layers x {enc_cfg.encoder_embed_dim}, decoder "
        f"{dec_cfg.layers} x {dec_cfg.embed_dim} ({dec_cfg.heads} heads, {dec_cfg.vocab_size} "
        f"tokens); batch {B} x {frames} frames audiovisual, stacked filterbanks on the host "
        f"in {fbank_s:.2f} s")

    def trainer_for(head, freeze, remat):
        return S2STrainer(enc_cfg, dec_cfg, head, {"enc": enc, "head": heads[head]}, 1e-4, 1,
                          freeze, DEV, blank_id=0, remat=remat)

    def batch_step(trainer):
        return lambda i: trainer.step(video, afeats, video_len, tgt, tgt_len,
                                      prng.fold_in(key, i))

    trainer = None
    for label, head, freeze, remat, n, want in (
            ("s2s", "s2s", False, "dots", 2, counts(B3=2 * L, B4=L)),
            ("ctc", "ctc", False, "off", 1, counts(B3=L, B4=L)),
            ("s2s frozen encoder", "s2s", True, "dots", 1, counts(B3=L))):
        del trainer
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = trainer_for(head, freeze, remat)
        enc_before = [p.detach().clone() for p, d in zip(trainer.leaves, trainer.decay) if not d]
        times, losses, launches = family_steps(f"(l) {label} step", batch_step(trainer), n, want,
                                               fns)
        if freeze:
            enc_after = [p for p, d in zip(trainer.leaves, trainer.decay) if not d]
            if not enc_before or not all(torch.equal(a, b) for a, b in zip(enc_before, enc_after)):
                raise RuntimeError("(l) --freeze-encoder: an encoder master moved")
        dt = float(np.median(times))
        rows[label] = dict(head=head, freeze_encoder=freeze, remat=remat, s_per_step=dt,
                           s_per_step_each=times, train_audio_s_per_s=clip_s / dt, losses=losses,
                           launches=launches, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        log("s2s", f"(l) {label} train step: {json.dumps(rows[label])}")
        del enc_before
        if label == "s2s":
            def s2s_grads(dtype):
                trainer.dtype = dtype
                try:
                    return trainer.loss_and_grads(video, afeats, video_len, tgt, tgt_len,
                                                  prng.fold_in(key, 99))
                finally:
                    trainer.dtype = torch.bfloat16

            agree = route_grads("(l) one s2s train step", s2s_grads, fns)
            rows[label]["route_agreement"] = agree
            dec_bf = tree_map(lambda x: x.detach().to(torch.bfloat16), trainer.masters["head"])
            # random weights end a decode at its first step; with EOS's embedding
            # row zeroed (its tied logit 0, below the top 2K of 1000) every
            # decode runs all S2S_TOKENS steps
            dec_bf["embed"]["w"][dec_cfg.eos_id] = 0.0
            enc_bf = tree_map(lambda x: x.detach().to(torch.bfloat16), trainer.masters["enc"])
    del trainer
    torch.cuda.empty_cache()

    # eval_avhubert_s2s's decode path in bf16
    @torch.no_grad()
    def encode():
        v = video_pipeline(video, video_len, train=False)
        return avhubert_encode(enc_bf, enc_cfg, v.to(torch.bfloat16),
                               audio=afeats.to(torch.bfloat16), lengths=video_len)

    torch.cuda.reset_peak_memory_stats()
    for label, run in (
            ("greedy", lambda: s2s_greedy_decode(dec_bf, dec_cfg, encode(), video_len,
                                                 S2S_TOKENS)),
            (f"beam {S2S_BEAMS}", lambda: s2s_beam_decode(dec_bf, dec_cfg, encode(), video_len,
                                                          S2S_TOKENS, S2S_BEAMS))):
        out = {}
        times, _, launches = family_steps(f"(l) {label} decode", lambda i: out.setdefault(
            i, run()).tokens.float().mean(), 1, counts(B3=L), fns)
        toks = out[1].tokens
        if tuple(toks.shape) != (B, S2S_TOKENS) or not bool(((toks >= 0) & (
                toks < dec_cfg.vocab_size)).all()):
            raise RuntimeError(f"(l) {label}: tokens {tuple(toks.shape)}")
        rows[label] = dict(s_per_batch=times[0], audio_s_per_s=clip_s / times[0],
                           decode_steps=out[1].steps, launches=launches,
                           peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                           first_tokens=toks[0, :8].tolist())
        log("s2s", f"(l) {label} decode (bf16, max_len {S2S_TOKENS}): {json.dumps(rows[label])}")

    # the first two decode steps' logits, encoder through B3 and through plain
    steps = {}
    tok1 = None
    for route in ("kernel", "plain"):
        with plain_train_route() if route == "plain" else contextlib.nullcontext():
            reset_counts(fns)
            enc_out = encode()
            check_route_launches(route, launches_now(fns))
        with torch.no_grad():
            ck, cv, cm, sk, sv, layers = _decode_setup(dec_bf, dec_cfg, enc_out, video_len, 2)
            bos = torch.full((B,), dec_cfg.eos_id, dtype=torch.long, device=DEV)
            l0, sk, sv = _s2s_decode_step(dec_bf, dec_cfg, bos, 0, sk, sv, ck, cv, cm,
                                          layers=layers)
            tok1 = l0.argmax(-1) if tok1 is None else tok1  # both routes take the same tokens
            l1, _, _ = _s2s_decode_step(dec_bf, dec_cfg, tok1, 1, sk, sv, ck, cv, cm,
                                        layers=layers)
        steps[route] = torch.cat([l0, l1]).float()
    rel = ((steps["kernel"] - steps["plain"]).norm() / steps["plain"].norm()).item()
    if rel > REL_L2_TOL or not bool(torch.isfinite(steps["kernel"]).all()):
        raise RuntimeError(f"(l) decode logits, kernel vs plain: relative L2 {rel:.3g}")
    rows["greedy"]["decode_rel_l2"] = rel
    log("reference", f"(l) encoder + the first two decode steps, B3 vs plain: relative L2 logit "
        f"difference {rel:.3g} (tol {REL_L2_TOL})")
    del enc, heads, enc_bf, dec_bf
    torch.cuda.empty_cache()
    return {f"l {k}": dict(config=f"(l) AV-HuBERT s2s B {B} x {frames} {k}", **v)
            for k, v in rows.items()}


def pretrain_phase(work: Path, cfg=None, n_units: int = 100, final_dim: int = 256,
                   B: int = B_TRAIN, frames: int = FRAMES_TRAIN, dump_layer: int = 12,
                   clusters: int = 100):
    """(m): `pretrain_avhubert`'s step at its defaults (100 units, final_dim
    256, mask prob 0.8, length 10, modality dropout 0.5, audio dropout 0.5)
    on AV-HuBERT Large, random weights from a seed, B clips of `frames`
    frames with the CLI's demo targets: one warm and one measured step
    (remat "dots": B3 2 x 24, B4 24), its loss and grads on the kernel and
    the plain route; the encoder and head saved in the port's checkpoint
    format; then `cluster_units`' layer-12 dump of one clip from that
    checkpoint (`make_avhubert_reader`, B3 12) and a `kmeans_fit` of 100
    clusters over the dumped frames (numpy, on the host). Returns the rows."""
    import torch

    from omni_avsr_tpu_torch.bridge import init_avhubert, init_pretrain_head
    from omni_avsr_tpu_torch.cli.cluster_units import (kmeans_assign, kmeans_fit,
                                                       make_avhubert_reader)
    from omni_avsr_tpu_torch.cli.pretrain_avhubert import demo_targets, pretrain_loss
    from omni_avsr_tpu_torch.config import TrainConfig, avhubert_large
    from omni_avsr_tpu_torch.data.audio_features import stacked_fbank
    from omni_avsr_tpu_torch.train.checkpoint import save_checkpoint
    from omni_avsr_tpu_torch.train.optim import make_optimizer
    from omni_avsr_tpu_torch.train.state import TrainState, master_weights, tree_leaves, tree_map
    from omni_avsr_tpu_torch.utils import prng

    cfg = cfg or avhubert_large(use_lora=False)
    L = cfg.encoder_layers
    video_np, audio_np = av_clips(B, frames, seed=8)
    afe = np.stack([stacked_fbank(audio_np[i], frames) for i in range(B)])
    video = torch.from_numpy(video_np).to(DEV)
    afeats = torch.from_numpy(afe).to(DEV)
    targets = torch.from_numpy(demo_targets(audio_np, frames, n_units)).to(DEV)
    lengths = torch.full((B,), frames, dtype=torch.int32, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    masters = master_weights({"enc": init_avhubert(cfg, gen, DEV),
                              "head": init_pretrain_head(cfg, n_units, final_dim, gen, DEV)}, DEV)
    leaves = list(tree_leaves(masters))
    tx, _ = make_optimizer(TrainConfig(lr=2e-4, max_epochs=1), 100)
    state = [tx.init(leaves)]
    key = prng.PRNGKey(23)
    kw = dict(mask_prob=0.8, mask_length=10, modality_dropout=0.5, audio_dropout=0.5)
    aux_last = {}

    def loss_and_grads(k, dtype=torch.bfloat16):
        params = tree_map(lambda x: x.to(dtype), masters)
        loss, aux = pretrain_loss(params, cfg, video, afeats, targets, lengths, k, dtype, "dots",
                                  **kw)
        aux_last.update({n: float(v.detach()) for n, v in aux.items()})
        return loss.detach(), list(torch.autograd.grad(loss, leaves))

    def step(i):
        loss, grads = loss_and_grads(prng.fold_in(key, i))
        state[0] = tx.update_(leaves, grads, state[0])
        return loss

    fns = counters()
    times, losses, launches = family_steps("(m) pretrain step", step, 1, counts(B3=2 * L, B4=L),
                                           fns)
    dt = times[0]
    rows = {"pretrain": dict(s_per_step=dt, train_audio_s_per_s=B * frames / 25.0 / dt,
                             losses=losses, aux=dict(aux_last), launches=launches,
                             peak_gib=torch.cuda.max_memory_allocated() / 2**30)}
    log("pretrain", f"(m) pretrain step: {json.dumps(rows['pretrain'])}")
    rows["pretrain"]["route_agreement"] = route_grads(
        "(m) one pretrain step", lambda dtype: loss_and_grads(prng.fold_in(key, 99), dtype), fns)

    out = work / "pretrain"
    ckpt = save_checkpoint(str(out / "checkpoints"), 1, TrainState(1, masters, state[0]))
    (out / "config.json").write_text(json.dumps({"avhubert": dataclasses.asdict(cfg),
                                                 "n_units": n_units, "final_dim": final_dim}))
    del masters, leaves, state
    torch.cuda.empty_cache()
    reader = make_avhubert_reader(ckpt, str(out / "config.json"), dump_layer, DEV)
    feats = {}
    times, _, launches = family_steps(f"(m) layer-{dump_layer} dump", lambda i: float(
        feats.setdefault(i, reader(video_np[0], audio_np[0])).mean()), 1,
        counts(B3=dump_layer), fns)
    f = feats[1]
    if f.shape != (frames, cfg.encoder_embed_dim) or not np.isfinite(f).all():
        raise RuntimeError(f"(m) layer-{dump_layer} features {f.shape}")
    t = time.perf_counter()
    C = kmeans_fit(f, clusters)
    km_s = time.perf_counter() - t
    labels = kmeans_assign(f, C)
    rows["dump"] = dict(layer=dump_layer, frames=frames, s_per_clip=times[0],
                        audio_s_per_s=frames / 25.0 / times[0], launches=launches,
                        kmeans_s=km_s, clusters=int(C.shape[0]),
                        distinct_labels=int(len(np.unique(labels))))
    log("pretrain", f"(m) layer-{dump_layer} dump of one clip + k-means of {clusters}: "
        f"{json.dumps(rows['dump'])}")
    del reader
    torch.cuda.empty_cache()
    return {f"m {k}": dict(config=f"(m) AV-HuBERT pretrain B {B} x {frames} {k}", **v)
            for k, v in rows.items()}


# ------------------------------------------------- (f): corpus eval + train

# (f)'s corpus: `generate_corpus` with the JAX function's parameters, clips
# of 150-160 frames (6.0-6.4 s, the length of (b)'s requests), seed 0
CORPUS_F = dict(n_train=8, n_val=2, n_test=6, min_frames=150, max_frames=160, seed=0)
F_TASKS = (("audio", 4, None), ("video", None, 2), ("audiovisual", 4, 2))  # first rates


def _tensor_leaves(x):
    """The tensors of a nested dict / list / tuple (a parameter tree, a
    TrainState with its optimizer state), dict keys in sorted order."""
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _tensor_leaves(x[k])
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensor_leaves(v)
    elif hasattr(x, "is_floating_point"):
        yield x


def eval_launches(model, task: str, steps: int, video_frames: int):
    """What one test batch of `task` must launch at pad30s with the int8
    tree: B1 in every LLM layer of every decode step; B2 in the six
    matrices of every layer of each tower the task runs and in every LLM
    matrix of the prefill and of each decode step; B3 in Whisper's layers
    (T 1500), and in AV-HuBERT's when its padded video reaches the flash
    gate."""
    from omni_avsr_tpu_torch.ops.attention import FLASH_MIN_T_TRAIN

    c = model.cfg
    use_a, use_v = task != "video", task != "audio"
    L, W, A = c.llm.num_layers, c.whisper.num_layers, c.avhubert.encoder_layers
    return counts(B1=L * steps,
                  B2=6 * (W * use_a + A * use_v) + (4 * L + 1) * (1 + steps),
                  B3=W * use_a + A * (use_v and video_frames >= FLASH_MIN_T_TRAIN))


def corpus_phase(work: Path):
    """(f): a corpus written by `generate_corpus`, read by `DataModule`,
    evaluated and trained on at full width as `cli/eval_omni.py` and
    `cli/train_omni.py` do. Evaluation: `test_batches(3)` of each task at
    its first rates through `OmniEngine.decode_batch` on the int8 tree of
    `eval_omni --quantize-decode int8` (beam 15, 32 new tokens, the 30 s
    window), WER by `WerAccumulator`. Training: two epochs of
    `train_batches` through `OmniEngine.train_step`, `save_checkpoint`
    after each, then `restore_checkpoint` and `average_last_n`. Every batch
    and step has its launches held to the count the path must give.
    Returns the rows by configuration."""
    import shutil

    import torch

    from omni_avsr_tpu_torch.bridge import init_params
    from omni_avsr_tpu_torch.cli.eval_omni import decode_tree
    from omni_avsr_tpu_torch.config import DataConfig, TrainConfig
    from omni_avsr_tpu_torch.data.datamodule import DataModule
    from omni_avsr_tpu_torch.data.noise import load_noise_bank
    from omni_avsr_tpu_torch.data.synthetic import generate_corpus
    from omni_avsr_tpu_torch.models.omni import flagship
    from omni_avsr_tpu_torch.ops.attention import FLASH_MIN_T_TRAIN
    from omni_avsr_tpu_torch.train.checkpoint import (
        average_last_n,
        latest_checkpoint,
        list_checkpoints,
        restore_checkpoint,
        save_checkpoint,
    )
    from omni_avsr_tpu_torch.train.engine import OmniEngine
    from omni_avsr_tpu_torch.train.state import TrainState
    from omni_avsr_tpu_torch.utils.metrics import WerAccumulator
    from omni_avsr_tpu_torch.utils.prefetch import device_prefetch

    shutil.rmtree(work, ignore_errors=True)
    t = time.perf_counter()
    corpus = work / "corpus"
    train_csv, val_csv, test_csv = generate_corpus(str(corpus), **CORPUS_F)
    log("corpus", f"(f) generate_corpus {json.dumps(CORPUS_F)} in {time.perf_counter() - t:.1f} s")
    data_cfg = DataConfig(root_dir=str(corpus), train_file=train_csv, val_file=val_csv,
                          test_file=test_csv, num_workers=4)
    model = flagship(tiny=False)  # pad30s, beam 15, 32 new tokens
    params = init_params(model.cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    engine = OmniEngine(model, params, TrainConfig(), 1.0, seed=0, device=DEV)
    tree = decode_tree(engine, "int8")  # as `eval_omni --quantize-decode int8` builds it
    fns = counters()
    rows = {}
    for task, ra, rv in F_TASKS:
        dm = DataModule(data_cfg, model.tok, modality=task)
        # a warm pass over the test set (first use of the task's shapes), then
        # the measured one; every batch's launches held to the count
        for measured in (False, True):
            acc = WerAccumulator()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times, launches_each, steps_each, shapes, clip_s = [], [], [], [], 0.0
            for batch in dm.test_batches(3):
                reset_counts(fns)
                t = time.perf_counter()
                hyps = engine.decode_batch(tree, batch, task, ra, rv)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
                launches = {name: fn.launches for name, fn in fns.items()}
                frames = batch["video"].shape[1] if "video" in batch else 0
                want = eval_launches(model, task, engine.last_decode_steps, frames)
                if launches != want:
                    raise RuntimeError(f"(f) eval {task}: kernel launches {launches}, expected "
                                       f"{want} for {engine.last_decode_steps} decode steps")
                if (len(hyps) != len(batch["gold_text"])
                        or not all(isinstance(h, str) for h in hyps)):
                    raise RuntimeError(f"(f) eval {task}: bad hypotheses {hyps!r}")
                for ref, hyp in zip(batch["gold_text"], hyps):
                    acc.update(ref, hyp)
                launches_each.append(launches)
                steps_each.append(engine.last_decode_steps)
                shapes.append(dict(clips=len(hyps), video_frames=frames,
                                   audio_trim=batch.get("audio_trim_len")))
                clip_s += (batch["audio_len"].sum() / 16000 if "audio_len" in batch
                           else batch["video_len"].sum() / 25.0)
            if not measured:
                warm_s = times
        if acc.total_length == 0 or not np.isfinite(acc.wer):
            raise RuntimeError(f"(f) eval {task}: WER {acc.wer} over {acc.total_length} words")
        row = dict(config=f"(f) eval {task} a={ra} v={rv}, pad30s int8 beam 15",
                   batches=len(times), batch_s_each=times, warm_pass_batch_s=warm_s,
                   s_per_batch=float(np.median(times)), audio_s=float(clip_s),
                   audio_s_per_s=float(clip_s / sum(times)), decode_steps_each=steps_each,
                   batch_shapes=shapes, launches=launches_each[-1], launches_each=launches_each,
                   wer=acc.wer, wer_counts=[acc.total_edit_distance, acc.total_length],
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        log("corpus", json.dumps(row))
        for ref, hyp in zip(batch["gold_text"], hyps):
            log("corpus", f"{task}: GOLD {ref!r} HYP {hyp[:80]!r}")
        rows[f"f {task}"] = row
    profile_batch("(f) eval audiovisual", lambda: engine.decode_batch(tree, batch, "audiovisual",
                                                                      4, 2))
    del tree, engine
    torch.cuda.empty_cache()

    # training, as `train_omni` runs it: the epoch's bucketed batches, the
    # engine's random rates (recorded to derive each step's launches)
    dm = DataModule(data_cfg, model.tok)
    steps_per_epoch = dm.steps_per_epoch()
    engine = OmniEngine(model, params, TrainConfig(lr=1e-3, max_epochs=2), steps_per_epoch,
                        noise_bank=load_noise_bank(None), seed=0, device=DEV)
    del params
    rates = []
    sample = engine.sample_rates
    engine.sample_rates = lambda: rates.append(sample()) or rates[-1]
    ckpt_dir = work / "train" / "checkpoints"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, launches_each, losses, batch_shapes, save_s, val_losses = [], [], [], [], [], []
    for epoch in range(2):
        # as `train_omni` feeds it: the next batches upload on a side stream
        for batch in device_prefetch(dm.train_batches(epoch), device=DEV):
            reset_counts(fns)
            t = time.perf_counter()
            loss = float(engine.train_step(batch))  # a host sync: the step has ended
            times.append(time.perf_counter() - t)
            launches = {name: fn.launches for name, fn in fns.items()}
            ra, rv = rates[-1]
            frames = batch["video"].shape[1]
            lengths = llm_lengths(model, batch["audio_trim_len"], ra, rv, frames,
                                  batch["tokens"].shape[1])
            flash = sum(n >= FLASH_MIN_T_TRAIN for n in lengths.values())
            video_layers = model.last_video_layers if frames >= FLASH_MIN_T_TRAIN else 0
            want = train_launches(model, flash, video_layers)
            if launches != want:
                raise RuntimeError(f"(f) train step: kernel launches {launches}, expected {want} "
                                   f"(rates {ra}/{rv}, LLM lengths {lengths}, video {frames})")
            if not np.isfinite(loss):
                raise RuntimeError(f"(f) train step: loss {loss}")
            losses.append(loss)
            launches_each.append(launches)
            batch_shapes.append(dict(clips=int(batch["video"].shape[0]), video_frames=frames,
                                     audio_trim=int(batch["audio_trim_len"]), rates=[ra, rv],
                                     llm_lengths=lengths))
        val = [float(engine.eval_step(b)[0]) for b in dm.val_batches()]
        val_losses.append(float(np.mean(val)))
        t = time.perf_counter()
        save_checkpoint(str(ckpt_dir), engine.state.step, engine.state, keep=4)
        save_s.append(time.perf_counter() - t)
    if len(list_checkpoints(str(ckpt_dir))) != 2:
        raise RuntimeError(f"(f) checkpoints: {list_checkpoints(str(ckpt_dir))}")
    t = time.perf_counter()
    restored = restore_checkpoint(latest_checkpoint(str(ckpt_dir)), DEV)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    saved, back = list(_tensor_leaves(engine.state)), list(_tensor_leaves(restored))
    if restored.step != engine.state.step or len(saved) != len(back) or not all(
            torch.equal(a.detach(), b.detach()) for a, b in zip(saved, back)):
        raise RuntimeError("(f) the restored state differs from the saved one")
    t = time.perf_counter()
    avg = average_last_n(str(ckpt_dir), 2)
    average_s = time.perf_counter() - t
    first, last = (restore_checkpoint(p, "cpu").trainable for p in list_checkpoints(str(ckpt_dir)))
    want_avg = [((a.detach().double() + b.detach().double()) / 2).float()
                for a, b in zip(_tensor_leaves(first), _tensor_leaves(last))]
    if not all(torch.equal(a, b) for a, b in zip(_tensor_leaves(avg), want_avg)):
        raise RuntimeError("(f) average_last_n is not the mean of the two checkpoints")
    t = time.perf_counter()
    save_checkpoint(str(work / "train" / "model_avg_2"), engine.state.step,
                    TrainState(engine.state.step, avg, engine.state.opt_state), keep=0)
    avg_save_s = time.perf_counter() - t
    # one more step, after the checks, under the profiler
    profile_batch("(f) train step", lambda: engine.train_step(batch))
    n_train = sum(int(v.numel()) for v in _tensor_leaves(engine.state.trainable))
    ckpt_mb = Path(latest_checkpoint(str(ckpt_dir))).stat().st_size / 2**20
    row = dict(config="(f) train, DataModule batches, pad30s", steps_per_epoch=steps_per_epoch,
               steps=len(times), step_s_each=times, s_per_step=float(np.median(times)),
               losses=losses, val_losses=val_losses, batch_shapes=batch_shapes,
               launches=launches_each[-1], launches_each=launches_each, save_s_each=save_s,
               restore_s=restore_s, average_s=average_s, average_save_s=avg_save_s,
               checkpoint_mib=ckpt_mb, trainable_params=n_train,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log("corpus", json.dumps(row))
    rows["f train"] = row
    del engine, restored, avg
    torch.cuda.empty_cache()

    # the same two epochs from the same masters and seed, uploaded
    # synchronously: the loss sequence must be bit-equal
    params = init_params(model.cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    engine = OmniEngine(model, params, TrainConfig(lr=1e-3, max_epochs=2), steps_per_epoch,
                        noise_bank=load_noise_bank(None), seed=0, device=DEV)
    del params
    t = time.perf_counter()
    sync_losses = []
    for epoch in range(2):
        for batch in dm.train_batches(epoch):
            sync_losses.append(float(engine.train_step(batch)))
        for b in dm.val_batches():  # the eval steps draw rates too, as above
            engine.eval_step(b)
    if sync_losses != losses[:len(sync_losses)] or len(sync_losses) != len(losses):
        raise RuntimeError(f"(f) device_prefetch changed the losses: {losses} vs synchronous "
                           f"{sync_losses}")
    row["synchronous_losses_equal"] = True
    row["synchronous_run_s"] = time.perf_counter() - t
    log("corpus", f"(f) {len(losses)} steps through device_prefetch: losses bit-equal to a "
        f"synchronous upload's ({row['synchronous_run_s']:.1f} s)")
    del engine
    torch.cuda.empty_cache()
    return rows


# Runs a CLI module as `python -m` does (`runpy`, as `__main__`, with its
# arguments in `sys.argv`), then prints the kernels' launches in its process
# on the last line and exits with the module's own code.
RUN_COUNTED = """
import json, runpy, sys
from chip_smoke import counters
fns = counters()
sys.argv = sys.argv[1:]
code = 0
try:
    runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
except SystemExit as e:
    code = e.code
print(json.dumps({name: fn.launches for name, fn in fns.items()}))
sys.exit(code)
"""


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def serve_http_cli(root: Path):
    """`serve_http --synthetic --port <free>` as a subprocess on the card:
    /healthz answers, one audio request gets a 200 with a text; then the
    server is stopped (and killed if it does not stop)."""
    import urllib.request

    port = free_port()
    url = f"http://127.0.0.1:{port}"
    t = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "omni_avsr_tpu_torch.cli.serve_http",
                             "--synthetic", "--port", str(port)], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        health = None
        while health is None and time.perf_counter() - t < 300:
            if proc.poll() is not None:
                raise RuntimeError(f"serve_http: exit {proc.returncode}\n"
                                   f"{proc.stderr.read()[-4000:]}")
            try:
                with urllib.request.urlopen(f"{url}/healthz", timeout=5) as r:
                    health = json.loads(r.read())
            except OSError:
                time.sleep(0.5)
        up_s = time.perf_counter() - t
        if health != {"ok": True, "requests": 0, "batches": 0}:
            raise RuntimeError(f"serve_http: /healthz {health}")
        code, reply, req_s = _post(url, _request_body(
            {"audio": make_items([100], seed=11)[0]["audio"]}))
        if code != 200 or not isinstance(reply.get("text"), str) or reply["batch_size"] != 1:
            raise RuntimeError(f"serve_http: {code} {reply}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    row = dict(cli="serve_http --synthetic", up_s=up_s, request_s=req_s, reply=reply,
               wall_s=time.perf_counter() - t)
    log("cli", json.dumps(row))
    return row


def s2s_eval_files(root: Path) -> list:
    """`eval_avhubert_s2s`'s inputs at the tiny widths: a corpus of 2 test
    clips (`generate_corpus`), a fairseq AVHubertSeq2Seq checkpoint of
    random trees (`avhubert_s2s_state_dict`) and its word dictionary; the
    flags that point the CLI at them."""
    import torch

    from omni_avsr_tpu_torch.bridge import init_avhubert, init_s2s_decoder
    from omni_avsr_tpu_torch.config import AVHubertConfig
    from omni_avsr_tpu_torch.convert.avhubert_s2s_torch import avhubert_s2s_state_dict
    from omni_avsr_tpu_torch.data.synthetic import WORDS, generate_corpus
    from omni_avsr_tpu_torch.models.avhubert_s2s import S2SDecoderConfig

    root.mkdir(parents=True)
    _, _, test_csv = generate_corpus(str(root), n_train=1, n_val=1, n_test=2, min_frames=24,
                                     max_frames=32)
    words = sorted(set(WORDS))
    g = torch.Generator().manual_seed(0)
    enc = init_avhubert(AVHubertConfig(encoder_embed_dim=64, encoder_layers=2, encoder_heads=4,
                                       encoder_ffn_dim=128), g, "cpu")
    dec = init_s2s_decoder(S2SDecoderConfig(vocab_size=4 + len(words), embed_dim=32, ffn_dim=64,
                                            layers=2, heads=4, encoder_dim=64), g, "cpu")
    sd = {k: torch.from_numpy(v) for k, v in avhubert_s2s_state_dict(enc, dec).items()}
    torch.save({"model": sd}, root / "s2s.pt")
    (root / "dict.wrd.txt").write_text("".join(f"{w.upper()} 1\n" for w in words))
    return ["--ckpt", str(root / "s2s.pt"), "--dict", str(root / "dict.wrd.txt"), "--root-dir",
            str(root), "--test-file", test_csv, "--encoder-layers", "2", "--encoder-dim", "64",
            "--encoder-heads", "4", "--encoder-ffn-dim", "128", "--decoder-layers", "2",
            "--decoder-embed-dim", "32", "--decoder-ffn-dim", "64", "--decoder-heads", "4"]


FAMILY_CLIS = ("train_avhubert_s2s s2s video", "train_avhubert_s2s ctc audiovisual",
               "eval_avhubert_s2s", "pretrain_avhubert", "cluster_units mfcc",
               "cluster_units avhubert")


def family_cli_runs(work: Path) -> list:
    """The AV-HuBERT family's CLIs at the tiny `--synthetic` widths (head
    size 12: no flash, so no kernel launch), in FAMILY_CLIS' order:
    `train_avhubert_s2s` with each head (video, audiovisual; the CTC run
    with a frozen encoder), `eval_avhubert_s2s` on a synthetic fairseq
    checkpoint (beam 3, audiovisual), `pretrain_avhubert --synthetic 4`
    for 2 steps, and `cluster_units` on its corpus with MFCC units and
    with the layer-2 features of its checkpoint."""
    runs = []
    for head, modality, freeze in (("s2s", "video", "false"), ("ctc", "audiovisual", "true")):
        runs.append((f"train_avhubert_s2s {head} {modality}", [
            "train_avhubert_s2s", "--synthetic", "4", "--head", head, "--modality", modality,
            "--freeze-encoder", freeze, "--max-epochs", "1", "--max-dec-len", "8", "--exp-dir",
            str(work / f"s2s_{head}")]))
    runs.append(("eval_avhubert_s2s", ["eval_avhubert_s2s"] + s2s_eval_files(work / "s2s_eval")
                 + ["--modality", "audiovisual", "--num-beams", "3", "--max-len", "6"]))
    pre = work / "pretrain_cli"
    runs.append(("pretrain_avhubert", ["pretrain_avhubert", "--synthetic", "4", "--max-steps",
                                       "2", "--exp-dir", str(pre)]))
    for features in ("mfcc", "avhubert"):
        runs.append((f"cluster_units {features}", [
            "cluster_units", "--root-dir", str(pre / "synthetic_data"), "--manifest",
            str(pre / "synthetic_data" / "train.csv"), "--out-dir", str(work / f"units_{features}"),
            "--n-clusters", "4", "--iters", "3", "--features", features]
            + (["--layer", "2", "--ckpt", str(pre / "checkpoints")] if features == "avhubert"
               else [])))
    assert [label for label, _ in runs] == list(FAMILY_CLIS)
    return runs


def family_cli_result(label: str, stdout: str, work: Path) -> dict:
    """The checks of one FAMILY_CLIS run's output and files; its result row."""
    if label.startswith("train_avhubert_s2s"):
        wants_wer = " s2s " in f" {label} "
        if "epoch 0: loss=" not in stdout or ("WER:" in stdout) != wants_wer:
            raise RuntimeError(f"{label}: output\n{stdout[-2000:]}")
        result = dict(lines=[ln for ln in stdout.splitlines()
                             if ln.startswith(("epoch", "WER"))])
    elif label == "eval_avhubert_s2s":
        hyps = [ln for ln in stdout.splitlines() if ln.startswith("HYP :")]
        wer = [ln for ln in stdout.splitlines() if ln.startswith("WER:")]
        if len(hyps) != 2 or len(wer) != 1:
            raise RuntimeError(f"{label}: output\n{stdout[-2000:]}")
        result = dict(hyps=hyps, wer=wer[0])
    elif label == "pretrain_avhubert":
        ckpts = sorted(p.name for p in (work / "pretrain_cli" / "checkpoints").glob("step_*"))
        if (ckpts != ["step_00000002.pt"] or "step 1: loss=" not in stdout
                or not (work / "pretrain_cli" / "config.json").exists()):
            raise RuntimeError(f"{label}: checkpoints {ckpts}\n{stdout[-2000:]}")
        result = dict(checkpoints=ckpts)
    elif label.startswith("cluster_units"):
        units = work / f"units_{label.split()[-1]}"
        km = sorted((units / "labels").glob("*.km"))
        rate = (units / "label_rate.txt").read_text()
        if (len(km) != 4 or np.load(units / "kmeans.npy").shape[0] != 4
                or rate != ("25" if label.endswith("avhubert") else "100")):
            raise RuntimeError(f"{label}: {len(km)} label files, rate {rate}")
        result = dict(label_files=len(km), label_rate=int(rate),
                      frames=[len(p.read_text().split()) for p in km])
    return result


CLI_WORKERS = 3  # CLI subprocesses at once on the card
SUBWORD_VOCAB = 64  # gen_subword's --vocab-size on (f)'s 8 transcripts


def subword_result(kind: str, stdout: str, work: Path) -> dict:
    """gen_subword's output: the dictionary loads in `FairseqDictionary`
    (for bpe with the ids of the `BPEEncoder` it saved beside it); then, on
    the corpus's token sizes (each transcript's BPE pieces), the
    token-block utilities in every break mode against their plain Python
    references."""
    from omni_avsr_tpu_torch.cli.eval_avhubert_s2s import FairseqDictionary
    from omni_avsr_tpu_torch.cli.gen_subword import read_texts
    from omni_avsr_tpu_torch.data.subword import BPEEncoder
    from omni_avsr_tpu_torch.utils import native

    out = work / f"subword_{kind}"
    d = FairseqDictionary(str(out / ("dict.ltr.txt" if kind == "char" else "dict.wrd.txt")))
    texts = read_texts(str(work / "corpus" / "train.csv"))
    result = dict(files=sorted(p.name for p in out.iterdir()), symbols=len(d))
    if d.symbols[:4] != ["<s>", "<pad>", "</s>", "<unk>"] or f"{len(texts)} transcripts" \
            not in stdout:
        raise RuntimeError(f"gen_subword {kind}: symbols {d.symbols[:8]}\n{stdout[-2000:]}")
    if kind == "bpe":
        enc = BPEEncoder.load(str(out / f"spm_bpe{SUBWORD_VOCAB}"))
        ids = [enc.encode(t) for t in texts]
        if d.symbols != enc.symbols or any(enc.decode(i) != " ".join(t.split())
                                           for i, t in zip(ids, texts)):
            raise RuntimeError(f"gen_subword bpe: the dictionary's ids are not the encoder's, "
                               f"or a transcript does not survive encode / decode")
        sizes = [len(i) for i in ids]
        blocks = {}
        for mode in ("none", "complete", "complete_doc", "eos"):
            sl = native.token_block_slices_native(sizes, mode, 16)
            idx = native.block_to_dataset_index_native(sizes, sl)
            if not (np.array_equal(sl, native.token_block_slices_py(sizes, mode, 16))
                    and np.array_equal(idx, native.block_to_dataset_index_py(sizes, sl))):
                raise RuntimeError(f"token blocks, {mode}: the library and the Python "
                                   f"reference differ on sizes {sizes}")
            blocks[mode] = len(sl)
        result.update(pieces=len(enc.pieces), token_sizes=sizes, token_blocks=blocks)
    return result


def cli_phase(work: Path, raw_clip_path: Path):
    """The CLIs as a user runs them, as subprocesses on the card
    (`--synthetic` runs at the JAX CLI's tiny widths): `serve_http` (one
    request), `eval_omni` with the int8 and the packed-int4 decode tree,
    `train_omni` for two epochs, `train_omni` and `eval_omni` with
    `--moe-experts 4` (the routing kernel must launch),
    `train_llama_avsr` for one epoch on audio,
    `eval_llama_avsr` on audio with the int8 LLM, `verify_parity` in three
    modes with (i)'s raw clip as its golden clip, and the preparation CLIs
    of (i): `preprocess_video` on (i)'s clip, `prepare_dataset` on 4 raw
    clips and `make_noise babble` on their wavs (`--detector center`, the
    ROI chain on the card). Each must exit 0 (verify_parity 1: random
    weights fail BASELINE.md, with all 8 settings measured) and give the
    result keys and files; the int8 runs must launch B2, the int4 run B6,
    and verify_parity both. Then the AV-HuBERT family's (`family_cli_runs`).
    All but serve_http run CLI_WORKERS at a time (two torch threads each),
    cluster_units after pretrain_avhubert; each run's wall s is taken
    beside the others."""
    root = Path(__file__).resolve().parent
    grid = [f"{t} (a={a}, v={v})" for t, a, v in
            [("audio", 4, None), ("audio", 16, None), ("video", None, 2), ("video", None, 5)]
            + [("audiovisual", a, v) for a in (4, 16) for v in (2, 5)]]
    corpus = work / "raw_corpus"
    corpus.mkdir(parents=True)
    for i in range(4):
        raw_clip(corpus, f"spk{i}-clip", 30 + 5 * i, seed=20 + i)
        (corpus / f"spk{i}-clip.txt").write_text(f"Text:  HELLO WORLD {i}\n")
    # the int8 run also passes the JAX package's --compilation-cache-dir (accepted)
    runs = [(f"eval_omni {q}", ["eval_omni", "--synthetic", "2", "--num-beams", "2",
                                "--max-dec-tokens", "4", "--quantize-decode", q,
                                "--print-hyp", "false", "--exp-dir", str(work / f"eval_{q}")]
             + (["--compilation-cache-dir", str(work / "xla_cache")] if q == "int8" else [])
             + ["--output-json", str(work / f"eval_{q}.json")])
            for q in ("int8", "int4")]
    runs.append(("train_omni", ["train_omni", "--synthetic", "4", "--max-epochs", "2",
                                "--exp-dir", str(work / "cli_train")]))
    # the MoE decoder (4 experts, balanced routing) at the tiny widths, unquantised
    runs.append(("train_omni moe", ["train_omni", "--synthetic", "4", "--tiny", "true",
                                    "--moe-experts", "4", "--max-epochs", "1",
                                    "--exp-dir", str(work / "cli_moe")]))
    runs.append(("eval_omni moe", ["eval_omni", "--synthetic", "2", "--num-beams", "2",
                                   "--max-dec-tokens", "4", "--moe-experts", "4", "--print-hyp",
                                   "false", "--exp-dir", str(work / "eval_moe"),
                                   "--output-json", str(work / "eval_moe.json")]))
    runs.append(("train_llama_avsr", ["train_llama_avsr", "--synthetic", "6", "--max-epochs", "1",
                                      "--modality", "audio", "--exp-dir", str(work / "llama")]))
    runs.append(("eval_llama_avsr int8", ["eval_llama_avsr", "--synthetic", "4", "--modality",
                                          "audio", "--quantize-decode", "int8", "--print-hyp",
                                          "false", "--exp-dir", str(work / "llama_eval")]))
    runs.append(("verify_parity", ["verify_parity", "--synthetic", "2", "--modes",
                                   "bf16,int8,int4", "--exp-dir", str(work / "parity"),
                                   "--output-json", str(work / "parity.json"),
                                   "--golden-clip", str(raw_clip_path)]))
    runs.append(("preprocess_video", ["preprocess_video", "--path-to-input-video",
                                      str(raw_clip_path), "--transcription", "HELLO",
                                      "--detector", "center", "--out-dir", str(work / "pre")]))
    runs.append(("prepare_dataset", ["prepare_dataset", "--input-dir", str(corpus),
                                     "--output-dir", str(work / "prepared"), "--dataset-name",
                                     "raw", "--detector", "center", "--num-workers", "2"]))
    runs.append(("make_noise babble", ["make_noise", "babble", "--input-dir", str(corpus),
                                       "--output", str(work / "noise" / "noise.wav"),
                                       "--num-per-mixture", "3", "--min-seconds", "1"]))
    runs += family_cli_runs(work)
    # the host-only vocabulary CLI on (f)'s transcripts, in its three kinds
    runs += [(f"gen_subword {kind}", ["gen_subword", "--input", str(work / "corpus" / "train.csv"),
                                      "--output-dir", str(work / f"subword_{kind}"),
                                      "--model-type", kind, "--vocab-size", str(SUBWORD_VOCAB)])
             for kind in ("bpe", "char", "word")]

    def run(item):
        label, argv = item
        # two torch threads a process: CLI_WORKERS processes share the host's
        # cores; the family's training CLIs under OMNI_REMAT=off: (l) and (m)
        # run the default "dots" at full width, whose first call costs ~9 s
        env = dict(os.environ, OMP_NUM_THREADS="2")
        if label in FAMILY_CLIS:
            env["OMNI_REMAT"] = "off"
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", RUN_COUNTED,
                               f"omni_avsr_tpu_torch.cli.{argv[0]}", *argv[1:]], cwd=root,
                              capture_output=True, text=True, timeout=600, env=env)
        return proc, time.perf_counter() - t

    rows = [serve_http_cli(root)]
    # the runs are independent but for cluster_units, which reads what
    # pretrain_avhubert wrote: CLI_WORKERS at a time, cluster_units after
    first = [r for r in runs if not r[0].startswith("cluster_units")]
    later = [r for r in runs if r[0].startswith("cluster_units")]
    with ThreadPoolExecutor(max_workers=CLI_WORKERS) as pool:
        done = list(pool.map(run, first)) + list(pool.map(run, later))
    for (label, argv), (proc, dt) in zip(first + later, done):
        # random weights fail BASELINE.md: verify_parity's exit 1 is the expected outcome
        if proc.returncode != (1 if label == "verify_parity" else 0):
            raise RuntimeError(f"{label}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
        launches = json.loads(proc.stdout.splitlines()[-1])
        kernel = {"eval_omni int8": ("B2",), "eval_omni int4": ("B6",),
                  "eval_llama_avsr int8": ("B2",), "verify_parity": ("B2", "B6"),
                  "train_omni moe": ("MOE",), "eval_omni moe": ("MOE",)}.get(label, ())
        if not all(launches[k] for k in kernel):
            raise RuntimeError(f"{label}: no {kernel} launch ({launches})")
        # the tiny model's head size 16 takes the reorder route: no B1 anywhere
        if launches["B1"]:
            raise RuntimeError(f"{label}: B1 launched at the tiny head size ({launches})")
        if label == "eval_omni int8" and "compiles no XLA program" not in proc.stdout:
            raise RuntimeError(f"{label}: no --compilation-cache-dir line\n{proc.stdout[-2000:]}")
        if label.startswith("eval_omni"):
            wer = json.loads(Path(argv[-1]).read_text())
            if list(wer) != grid:
                raise RuntimeError(f"{label}: result keys {list(wer)}, expected {grid}")
            result = dict(keys=len(wer), wer=wer)
        elif label == "train_omni moe":
            exp = work / "cli_moe" / "omni"
            ckpts = sorted(p.name for p in (exp / "checkpoints").glob("step_*.pt"))
            if not ckpts or "epoch 0:" not in proc.stdout:
                raise RuntimeError(f"{label}: checkpoints {ckpts}\n{proc.stdout[-2000:]}")
            result = dict(checkpoints=ckpts)
        elif label == "train_llama_avsr":
            exp = work / "llama" / "omni"
            ckpts = sorted(p.name for p in (exp / "checkpoints").glob("step_*.pt"))
            avg = sorted(p.name for p in (exp / "model_avg_4").glob("step_*.pt"))
            wer = [line.split(":")[0] for line in proc.stdout.splitlines()
                   if line.startswith("wer/")]
            if (len(ckpts) != 1 or not avg or wer != ["wer/audio_a4_vNone", "wer/audio_a16_vNone"]
                    or "epoch 0: loss=" not in proc.stdout):
                raise RuntimeError(f"{label}: checkpoints {ckpts}, average {avg}, WER {wer}")
            result = dict(checkpoints=ckpts, model_avg_4=avg, wer_lines=wer)
        elif label == "eval_llama_avsr int8":
            wer = [line for line in proc.stdout.splitlines() if line.startswith("WER audio")]
            if [w.split(":")[0] for w in wer] != ["WER audio (a=4, v=None)",
                                                  "WER audio (a=16, v=None)"]:
                raise RuntimeError(f"{label}: WER lines {wer}")
            result = dict(wer_lines=wer)
        elif label == "verify_parity":
            report = json.loads((work / "parity.json").read_text())
            statuses = [r["status"] for r in report["rows"]]
            golden = report.get("golden_clip", {})
            if (len(statuses) != 8 or "MISSING" in statuses or report["passed"]
                    or report["modes"] != ["bf16", "int8", "int4"]
                    or not all(r.get("int8") is not None and r.get("int4") is not None
                               for r in report["rows"])
                    or list(golden) != ["modality", "transcripts"]
                    or golden["modality"] != "audiovisual"
                    or list(golden["transcripts"]) != ["bf16", "int8", "int4"]):
                raise RuntimeError(f"{label}: report {json.dumps(report)[:2000]}")
            held = report["profile"]["reference_pins_held"]
            if (report["profile"]["requested"] != "reference" or len(held) != 8
                    or report["profile"]["reference_pins_not_held"]
                    or "8 of 8 reference pins held" not in proc.stdout):
                raise RuntimeError(f"{label}: profile {json.dumps(report['profile'])}")
            result = dict(statuses=statuses, worst_abs_delta=report["worst_abs_delta"],
                          rows=report["rows"], profile=report["profile"]["requested"],
                          reference_pins_held=held, golden_clip=golden)
        elif label == "preprocess_video":
            # `.npy` where OpenCV is not installed or has no mp4 writer
            out = sorted(p.name for p in (work / "pre").iterdir())
            written = "clip_preprocessed.mp4" if "clip_preprocessed.mp4" in out \
                else "clip_preprocessed.npy"
            manifest = (work / "pre" / "test_file.csv").read_text()
            if (manifest != f"pre,{written},{RAW_T},0,HELLO\n" or (
                    written.endswith(".npy")
                    and np.load(work / "pre" / written).shape != (RAW_T, 96, 96))):
                raise RuntimeError(f"{label}: wrote {out}, manifest {manifest!r}")
            result = dict(files=out, manifest=manifest.strip())
        elif label == "prepare_dataset":
            manifest = (work / "prepared" / "train.csv").read_text().splitlines()
            out = work / "prepared" / "raw"
            videos = [p for p in out.iterdir() if p.suffix in (".npy", ".mp4")]
            shapes = sorted(np.load(p).shape for p in videos if p.suffix == ".npy")
            wavs = sorted(out.glob("*.wav"))
            if (len(manifest) != 4 or len(videos) != 4 or len(wavs) != 4
                    or shapes not in ([], [(30 + 5 * i, 96, 96) for i in range(4)])
                    or "found 4 clips" not in proc.stdout):
                raise RuntimeError(f"{label}: manifest {manifest}, ROI shapes {shapes}, "
                                   f"{len(wavs)} wavs\n{proc.stdout[-2000:]}")
            result = dict(rows=manifest, roi_shapes=shapes)
        elif label in FAMILY_CLIS:
            result = family_cli_result(label, proc.stdout, work)
        elif label.startswith("gen_subword"):
            result = subword_result(label.split()[1], proc.stdout, work)
        elif label == "make_noise babble":
            from omni_avsr_tpu_torch.preprocess.noise_prep import read_wav_int16

            noise = read_wav_int16(str(work / "noise" / "noise.wav"))
            # the mix is as long as the shortest of the 3 clips it draws
            if len(noise) not in [(30 + 5 * i) * 640 for i in range(4)] \
                    or "mixed 3 clips" not in proc.stdout:
                raise RuntimeError(f"{label}: {len(noise)} samples\n{proc.stdout[-2000:]}")
            result = dict(samples=len(noise))
        else:
            exp = work / "cli_train" / "omni"
            ckpts = sorted(p.name for p in (exp / "checkpoints").glob("step_*.pt"))
            avg = sorted(p.name for p in (exp / "model_avg_4").glob("step_*.pt"))
            recs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
            wer = sorted(k for r in recs for k in r if k.startswith("wer/"))
            if len(ckpts) != 2 or not avg or len(wer) != 12 or "epoch 1:" not in proc.stdout:
                raise RuntimeError(f"{label}: checkpoints {ckpts}, average {avg}, WER keys {wer}")
            result = dict(checkpoints=ckpts, model_avg_4=avg, wer_keys=len(wer))
        row = dict(cli=label, exit=proc.returncode, wall_s=dt, launches=launches, **result)
        log("cli", json.dumps(row))
        rows.append(row)
    return rows


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


def graph_census(run) -> list:
    """The device work one call of `run` starts, read from a CUDA graph of
    that call: each kernel node's (mangled) function name, and
    "node type N" for any other node (a memset, a copy). Unlike
    torch.profiler it needs no CUPTI session, which a process on the H100
    machines is not always granted (a capture then holds no device
    records at all)."""
    import ctypes

    import torch

    class KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                    ("block", ctypes.c_uint * 3), ("shared_mem", ctypes.c_uint),
                    ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                    ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    cu = ctypes.CDLL("libcuda.so.1")

    def ok(rc, what):
        if rc != 0:
            raise RuntimeError(f"graph census: {what} returned CUresult {rc}")

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    torch.cuda.synchronize()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        run()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    ok(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names = []
    for node in nodes:
        node = ctypes.c_void_p(node)
        kind = ctypes.c_int(-1)
        ok(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            names.append(f"node type {kind.value}")
            continue
        params = KernelNodeParams()
        ok(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
           "cuGraphKernelNodeGetParams_v2")
        name = ctypes.c_char_p()
        if params.func:
            ok(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func)),
               "cuFuncGetName")
        else:
            ok(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(params.kern)),
               "cuKernelGetName")
        names.append(name.value.decode())
    del graph
    torch.cuda.synchronize()
    return names


def profile_batch(label: str, run) -> None:
    """Where the time goes: one more call of `run` (a served batch, a train
    step) under torch.profiler, recording the device's activities only,
    device kernels summed by name against the call's wall time (which the
    profiler itself lengthens). The sums read the profiler's raw records,
    without its event tree (`prof.events()` makes a Python object of every
    record and finds each one's parent: many times the profiled call's own
    time at 30k-110k records); the log line gives the seconds spent outside
    the profiled call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    by_name: dict = {}
    n = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns() / 1e3
            n += 1
    outside = time.perf_counter() - t0 - wall_us / 1e6
    if not n:
        log("profile", f"{label}: the profiler saw no device activity: device time not measured")
        return
    busy = sum(by_name.values())
    log("profile", f"{label}: one batch under the profiler: {wall_us / 1e3:.1f} ms wall, device "
        f"busy {busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%, idle "
        f"{100 - 100 * busy / wall_us:.1f}%), {n} device activities; {outside:.2f} s outside "
        f"the profiled call")
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

    smi = card()
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
    n_params = sum(int(v.numel()) for v in _tensor_leaves(server_a.params))
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
    rows["g"] = http_phase(server_a, model_a)
    # (i): a raw clip through (a)'s server; AV-HuBERT at its 160 frames is
    # under B3's gate, so B3 runs in Whisper's 24 layers only
    raw_rows, raw_clip_path = raw_phase(server_a, lambda s: counts(
        B1=layers_llm * s, B2=tower_b2 + llm_mats * (1 + s), B3=model_a.cfg.whisper.num_layers))
    rows.update(raw_rows)
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
    n_bf16 = sum(int(v.numel()) for v in _tensor_leaves(params))
    server_e = Transcriber(model_e, params, quantize="int8", device="cuda")
    del params
    torch.cuda.synchronize()
    build_e = dict(build_s=time.perf_counter() - t,
                   build_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log("model", f"(e) {QWEN_E}: {llm_e.num_layers} layers, hidden {llm_e.hidden_size}, "
        f"{llm_e.num_heads}/{llm_e.num_kv_heads} heads at D {llm_e.head_dim}, FFN "
        f"{llm_e.intermediate_size}, vocabulary {llm_e.vocab_size}, untied head; "
        f"{n_bf16 / 1e9:.3f} B parameters at init (bf16), int8 serving tree built layer by "
        f"layer from the bf16 tree on the card in {build_e['build_s']:.1f} s, peak "
        f"{build_e['build_peak_gib']:.1f} GiB while it was built (the whole-tree build peaked "
        f"at 43.2 GiB on an NVIDIA H100 80GB HBM3)")
    layers_e = llm_e.num_layers
    mats_e = 4 * layers_e + 1
    expect_e = lambda s: counts(B1=layers_e * s, B2=tower_b2 + mats_e * (1 + s))  # noqa: E731
    rows["e"] = serve("(e) Qwen2.5-7B bucket int8", server_e, items_b, expect_e,
                      repeats=SERVE_REPEATS_E)
    rows["e"]["build"] = build_e
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
    del server_e
    torch.cuda.empty_cache()

    # (n): Qwen2.5-32B int8 and Qwen2.5-14B int4 at full width, drawn layer by layer
    rows_n, b2_step_n, b6_step_n = big_qwen_phase(items_b, tower_b2, flush)
    rows.update(rows_n)
    # (o): the MoE decoder, served and trained
    rows_o, moe_k = moe_phase(items_b, flush)
    rows.update(rows_o)
    # (p): NCCL at world size 1, and the per-rank kernels of a tp mesh
    rows.update(parallel_phase(flush, items_b))
    # (q): the causal-LM loss (B3, B4), lightconv and checkify_step at full width
    rows.update(last_modules_phase(flush))
    # (r), (u), (v): multi-rank training and serving on gloo ranks sharing the card
    rows.update(multirank_phase())
    del flush
    torch.cuda.empty_cache()

    # the reference numerics profile: (j) serving, the threefry draws, (k) training
    rows.update(reference_serving_phase(model_a, items_a, model_b, items_b))
    threefry_check()
    rows["train"], train_agree, rows["train conv"] = train_phase()
    rows["k"] = reference_train_phase()
    rows.update(baseline_phase())
    work = Path(__file__).resolve().parent / "build" / "chip_smoke"
    rows.update(corpus_phase(work))
    rows.update(s2s_phase())
    rows.update(pretrain_phase(work))
    cli_rows = cli_phase(work, raw_clip_path)

    def entry(key, name, source, replaces, row, config, shape):
        """The kernel's line: its launches in the configuration whose main
        kernel it is, and in each configuration."""
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": rows[config]["launches"][key], "max_abs_err": row["max_abs_err"],
                "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"], "shape": shape,
                "launches_by_config": {c: r["launches"][key] for c, r in rows.items()},
                "launches_by_rank": {c: [x[key] for x in r["launches_by_rank"]]
                                     for c, r in rows.items() if "launches_by_rank" in r}}

    print(json.dumps({"kernels": [
        {**entry("B1", "beam_decode_attention", "omni_avsr_tpu_torch/csrc/beam_attention.cu",
                 "omni_avsr_tpu/ops/beam_attention.py:51", b1, "b",
                 "per launch: B 3 x 15 beams, P 176, step 17; cases: the timed shapes (K 15 "
                 "at P 176 and 400, K 1, K 65, K 128, and (e)'s Qwen2.5-7B: Hq 28 / Hkv 4, D "
                 "128)"),
         "cases": [b1, b1_a, b1_greedy, b1_k65, b1_k128, b1_e],
         "tp_shards": {k: v["B1"] for k, v in rows["p shards"]["shards"].items()}},
        {**entry("B2", "quantized_matmul", "omni_avsr_tpu_torch/csrc/quant_matmul.cu",
                 "omni_avsr_tpu/ops/quant.py:54", b2, "b",
                 "one decode step, M 45: 16 x (qkv, o, gateup, down) + lm_head; tower_ms and "
                 "prefill_ms: one (b) batch's tower and prefill launches, summed; per_batch: "
                 "(a), (b) and (e) by stage, qwen7b_decode_step: (e)'s per step"),
         "tower_ms": b2_batches["b"]["by_stage"]["tower"]["ms"],
         "prefill_ms": b2_batches["b"]["by_stage"]["prefill"]["ms"],
         "per_batch": {k: v["by_stage"] for k, v in b2_batches.items()},
         "qwen7b_decode_step": b2_batches["e"]["decode_step"],
         "qwen32b_decode_step": b2_step_n,
         "tower_fc1_m4500": b2["tower"],
         "tp_shards": {k: v["B2"] for k, v in rows["p shards"]["shards"].items()}},
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
         "timed": b5,
         "tp_shards": {k: v["B5"] for k, v in rows["p shards"]["shards"].items()}},
        {**entry("B6", "quantized_matmul4", "omni_avsr_tpu_torch/csrc/quant_matmul.cu",
                 "omni_avsr_tpu/ops/quant.py:156", b6, "c",
                 "one decode step, M 45: 16 x (qkv, o, gateup, down) + lm_head; per_batch: one "
                 "(c) batch's prefill and decode launches, summed"),
         "per_batch": b6_batch["by_stage"], "per_batch_shapes": b6_batch["shapes"],
         "qwen14b_decode_step_one_request": b6_step_n},
        {**entry("B7", "conv2d_fused", "omni_avsr_tpu_torch/csrc/conv_block.cu",
                 "omni_avsr_tpu/ops/conv_block.py:70", b7, "d",
                 "one ResNet trunk of 480 frames (19 convs, summed); library_ms is cuDNN's "
                 "bf16 conv in channels_last with the epilogue as torch ops"),
         "cases": b7["cases"], "trunk_rel_l2": b7["trunk_rel_l2"],
         "tflop_per_s": b7["tflop_per_s"]},
        {**entry("MOE", "balanced_assignment", "omni_avsr_tpu_torch/csrc/moe_route.cu",
                 "omni_avsr_tpu/models/moe.py:71", moe_k, "o",
                 "per launch: (o)'s prefill, 3 requests x 176 slots = 528 rows over 8 experts; "
                 "launches per (o) batch; cases: a decode step's 45 rows and a "
                 "train step's audio task, each bit-equal to the plain loop; kernel_ms: the "
                 "launch alone, without the wrapper's sort; real_logits: every routing call "
                 "of (o)'s first batch and first train step, bit-equal"),
         "cases": moe_k["cases"], "real_logits": moe_k["real_logits"],
         "replaces_note": "no TPU kernel: the JAX package's lax.scan greedy, "
                          "_topk_balanced_assignment, which runs inside its jitted decoder"},
    ]}), flush=True)
    log("done", f"{time.perf_counter() - T0:.1f} s in all")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
