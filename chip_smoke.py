#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`omni_avsr_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line with its elapsed seconds:
  1. the card: name and power limit, from nvidia-smi;
  2. the nvcc build of every kernel source in omni_avsr_tpu_torch/csrc/;
  3. each kernel against its plain PyTorch version at the serving shapes,
     with its time, the plain version's, a PyTorch library call's and the
     card's lower bound for the same work;
  4. the full-width flagship (Whisper-medium, ResNet3D + AV-HuBERT-Large,
     Llama-3.2-1B with task-specific Omni-LoRA), random weights made on the
     card from a seed;
  5. serving: `Transcriber.transcribe_many` with int8 decode weights,
     beam 15 and 32 new tokens answers 3 requests of 6.4 s audio plus 160
     mouth frames; every kernel of the path must have launched, and the
     beam-attention kernel exactly once per decoder layer per decode step;
  6. a reference check on those inputs: the first decode steps of the
     served model through the kernel and through the plain version agree.
Then a `kernels` JSON line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failure raises and exits non-zero; without a CUDA device the script
exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

T0 = time.perf_counter()
DEV = "cuda"

# B1 at the serving shapes: beams, new tokens, heads, head dim, prefix slots
# (the 172-token audiovisual prefix of a 6.4 s clip, rounded up to 16)
K, N, HQ, HKV, D, P = 15, 32, 32, 8, 64, 176
B_SERVE = 3  # the three requests decode as one batch
# bf16 inputs and output; the kernel keeps the probabilities in f32 where
# the plain version rounds them to bf16 before the value contraction
B1_TOL = dict(atol=2e-2, rtol=2e-2)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12  # H100 SXM dense bf16


def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {phase}: {msg}", flush=True)


def time_ms(fn, flush, iters: int = 50) -> float:
    """Mean device time of one call, each call started with a cold L2 (the
    decode loop streams the weights between two calls at one layer). A
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


def host_ms(fn, iters: int = 50) -> float:
    """Wall time per call of back-to-back calls, host launch overhead
    included (what a host-bound decode loop pays)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / iters


def b1_inputs(B: int, step: int, seed: int):
    import torch

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
    ), step


def b1_bound_ms(inp, step: int) -> float:
    """Least time for the same work: each input byte the result depends on
    read once (the live generated entries only), the output written once,
    over HBM bandwidth; the operations are ~1000x below the bf16 peak."""
    q, anc = inp["q"], inp["anc"]
    B = anc.shape[0]
    live_rows = sum(len({(int(r), n) for n in range(step) for r in anc[b, :, n].tolist()})
                    for b in range(B))
    byte = 2
    nbytes = (2 * q.numel() * byte                        # q and out
              + 2 * B * HKV * P * D * byte                # prefix K and V
              + 2 * live_rows * HKV * D * byte            # live generated K and V
              + 2 * inp["k_cur"].numel() * byte           # current K and V
              + inp["prefix_bias"].numel() * 4 + anc.numel() * 4)
    flops = 4 * q.shape[0] * HQ * D * (P + step + 1)
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3


def sdpa_on_reordered_cache(inp, step: int):
    """The library yardstick: one scaled_dot_product_attention call with an
    explicit mask over the physically reordered cache [prefix | beam's
    ancestor chain | current token]. Set-up is outside the timed call."""
    import torch
    import torch.nn.functional as F

    q, anc = inp["q"], inp["anc"]
    B = anc.shape[0]
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


def check_b1(flush):
    import torch

    from omni_avsr_tpu_torch.ops.beam_attention import (
        beam_decode_attention,
        beam_decode_attention_plain,
    )

    max_err, timed = 0.0, None
    for B in (1, B_SERVE, 4):
        for step in (0, 17, 31):
            inp, step = b1_inputs(B, step, seed=100 * B + step)
            out = beam_decode_attention(**inp, step=step, num_beams=K)
            ref = beam_decode_attention_plain(**inp, step=step, num_beams=K)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            torch.testing.assert_close(out.float(), ref.float(), **B1_TOL)
            sdpa = sdpa_on_reordered_cache(inp, step)().reshape(out.shape)
            torch.testing.assert_close(out.float(), sdpa.float(), **B1_TOL)
            max_err = max(max_err, err)
            kernel = lambda: beam_decode_attention(**inp, step=step, num_beams=K)  # noqa: E731
            row = dict(B=B, step=step, max_abs_err=err, ms=time_ms(kernel, flush),
                       host_ms=host_ms(kernel),
                       plain_ms=time_ms(lambda: beam_decode_attention_plain(
                           **inp, step=step, num_beams=K), flush),
                       library_ms=time_ms(sdpa_on_reordered_cache(inp, step), flush),
                       bound_ms=b1_bound_ms(inp, step))
            log("B1", json.dumps(row))
            if B == B_SERVE and step == 17:
                timed = row
    timed["max_abs_err"] = max_err
    return timed


def first_steps_agree(t, item, steps: int = 3) -> float:
    """Reference check on served inputs: the first decode steps of the
    full-width model, every layer's attention through the kernel and
    through the plain version (same device, same inputs, tokens fed from
    the kernel route). Returns the largest relative L2 logit difference."""
    import torch

    import omni_avsr_tpu_torch.models.llm as llm_mod
    from omni_avsr_tpu_torch.ops.beam_attention import beam_decode_attention_plain
    from omni_avsr_tpu_torch.ops.augment import audio_pipeline, video_pipeline
    from omni_avsr_tpu_torch.serve import pad_batch

    model, cfg = t.model, t.model.cfg.llm
    batch, trim = pad_batch([item], "audiovisual")
    arrays = {k: torch.as_tensor(v).to(DEV) for k, v in batch.items()}
    worst = 0.0
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
        cache0 = llm_mod.KVCache.create(cfg, 1, Pp, dtype=model.dtype, device=DEV)
        logits, cache0 = llm_mod.llm_prefill_masked(llm, cfg, prefix, valid, positions, last,
                                                    cache0, "audiovisual", layers=layers)
        caches = [llm_mod.AncSplitCache.from_prefill(cache0, Pp, K, N) for _ in range(2)]
        anc = torch.arange(K, dtype=torch.int32, device=DEV)[None, :, None].expand(1, K, N).contiguous()
        n_valid = valid.sum(dim=1).repeat_interleave(K)
        tok = torch.topk(logits[0], K).indices
        kernel_fn = llm_mod.beam_decode_attention
        for step in range(steps):
            flat_idx = torch.roll(torch.arange(K, device=DEV), step)  # exercise ancestry
            anc = llm_mod.update_ancestors(anc, flat_idx, step, K)
            emb = llm_mod.embed_tokens(llm, tok[:, None], model.dtype)
            outs = []
            for route, cache in zip((kernel_fn, beam_decode_attention_plain), caches):
                llm_mod.beam_decode_attention = route
                try:
                    lg, _ = llm_mod.llm_decode_step_beam_anc(
                        llm, cfg, emb, step, n_valid, valid, cache, anc, K, "audiovisual",
                        layers=layers)
                finally:
                    llm_mod.beam_decode_attention = kernel_fn
                outs.append(lg)
            if not bool(torch.isfinite(outs[0]).all()):
                raise RuntimeError(f"non-finite logits at decode step {step}")
            rel = ((outs[0] - outs[1]).norm() / outs[1].norm()).item()
            worst = max(worst, rel)
            tok = outs[0].argmax(dim=-1)
    return worst


def profile_batch(server, items) -> None:
    """Where the serving time goes: one more batch under torch.profiler,
    device kernels summed by name against the batch's wall time (which the
    profiler itself lengthens)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        server.transcribe_many(items)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log("profile", "the profiler saw no device activity: device time not measured")
        return
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    log("profile", f"one batch of 3 under the profiler: {wall_us / 1e3:.1f} ms wall, device busy "
        f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%, idle {100 - 100 * busy / wall_us:.1f}%), "
        f"{len(kernels)} device activities")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log("profile", f"{us / 1e3:8.2f} ms {100 * us / busy:5.1f}%  {name[:100]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from omni_avsr_tpu_torch import kernels
    from omni_avsr_tpu_torch.bridge import init_params
    from omni_avsr_tpu_torch.models.omni import flagship
    from omni_avsr_tpu_torch.ops.beam_attention import beam_decode_attention
    from omni_avsr_tpu_torch.serve import Transcriber

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
    log("build", f"nvcc {sources} in {time.perf_counter() - t:.2f} s")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    b1 = check_b1(flush)
    log("B1", f"kernel vs plain at the serving shapes: max_abs_err {b1['max_abs_err']:.3g} "
        f"(tol atol/rtol 2e-2); B {B_SERVE} step 17: {b1['ms'] * 1e3:.1f} us on the device "
        f"({b1['host_ms'] * 1e3:.1f} us per call from the host), plain "
        f"{b1['plain_ms'] * 1e3:.1f} us, SDPA {b1['library_ms'] * 1e3:.1f} us, "
        f"bound {b1['bound_ms'] * 1e3:.3f} us")
    del flush

    t = time.perf_counter()
    model = flagship(tiny=False)
    params = init_params(model.cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    server = Transcriber(model, params, quantize="int8", device="cuda")
    del params
    torch.cuda.synchronize()
    n_params = sum(int(v.numel()) for v in _leaves(server.params))
    log("model", f"flagship full width on the card, int8 decode weights: {n_params / 1e9:.3f} B "
        f"parameters, {time.perf_counter() - t:.1f} s")

    rng = np.random.RandomState(0)
    frames, secs = 160, 6.4
    items = [{"audio": (rng.randn(frames * 640) * 0.1).astype("float32"),
              "video": rng.randint(0, 255, (frames, 96, 96, 3)).astype("uint8")}
             for _ in range(3)]
    t = time.perf_counter()
    server.transcribe_many(items[:1])
    torch.cuda.synchronize()
    log("warmup", f"one request (first use of the card's libraries): {time.perf_counter() - t:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    beam_decode_attention.launches = 0
    t = time.perf_counter()
    texts = server.transcribe_many(items)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = beam_decode_attention.launches
    steps = server.last_decode_steps
    layers = model.cfg.llm.num_layers
    if launches == 0 or launches != layers * steps:
        raise RuntimeError(f"beam attention launched {launches} times, expected "
                           f"{layers} layers x {steps} decode steps")
    if len(texts) != 3 or not all(isinstance(s, str) and s for s in texts):
        raise RuntimeError(f"bad transcripts: {texts!r}")
    log("serve", f"3 requests x {secs} s as one batch: {dt:.3f} s, {dt / 3:.3f} s per request, "
        f"{3 * secs / dt:.1f} audio-s/s; {steps} decode steps, B1 launches {launches} "
        f"= {layers} x {steps}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for i, s in enumerate(texts):
        log("serve", f"request {i}: {s[:160]}")

    rel = first_steps_agree(server, items[0])
    if rel > 2e-2:
        raise RuntimeError(f"decode-step logits: kernel vs plain relative L2 {rel:.3g} > 2e-2")
    log("reference", f"first 3 decode steps at full width, kernel vs plain route: "
        f"relative L2 logit difference {rel:.3g} (tol 2e-2)")
    profile_batch(server, items)

    print(json.dumps({"kernels": [{
        "name": "beam_decode_attention",
        "route": "cuda",
        "source": "omni_avsr_tpu_torch/csrc/beam_attention.cu",
        "replaces": "omni_avsr_tpu/ops/beam_attention.py:51",
        "launches": launches,
        "max_abs_err": b1["max_abs_err"],
        "ms": b1["ms"],
        "plain_ms": b1["plain_ms"],
        "bound_ms": b1["bound_ms"],
        "bound_by": "bytes",
        "library_ms": b1["library_ms"],
    }]}), flush=True)
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
