#!/usr/bin/env python3
"""Times B1 (beam-decode attention), B3 (flash attention) and B5 (the
beam-selection row statistics) of one checkout of the port on the GPU, for
comparing two checkouts in one call:

    python3 scripts/ab_b1_b3_b5.py <checkout root> <label>

Run it once per checkout in turns (parent, change, change, parent), so
that both are measured on the same card. It imports `chip_smoke.py` and
`omni_avsr_tpu_torch` from the given root, builds that checkout's three
kernel sources there, and prints one line "AB {json}": B1 at chip_smoke.py's
three timed shapes (B 3, step 17; P 176 / 400 with 15 beams, P 176 with
1), B3 at Whisper's 30 s window (B 1 and B 3, 16 heads, T = S = 1500, D
64) and B5 at (d)'s selection shape (45 x 128256): device ms with a cold
L2 and, for B1 and B5, host ms per call (the median of 5 x 200
back-to-back calls).
"""

import json
import sys
from pathlib import Path

root = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(root))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from omni_avsr_tpu_torch import kernels  # noqa: E402
from omni_avsr_tpu_torch.ops.beam_attention import beam_decode_attention  # noqa: E402
from omni_avsr_tpu_torch.ops.flash_attention import flash_attention  # noqa: E402
from omni_avsr_tpu_torch.ops.select_topk import row_stats_chunkmax  # noqa: E402


def timed(fn, flush, host: bool) -> dict:
    row = {"ms": cs.time_ms(fn, flush)}
    if host:
        hosts = sorted(cs.host_ms(fn, iters=200) for _ in range(5))
        row.update(host_ms=hosts[2], host_ms_all=hosts)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_b1_b3_b5: no CUDA device", file=sys.stderr)
        return 2
    if not Path(kernels.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {kernels.__file__}, not the checkout at {root}")
    kernels.build_all(["beam_attention", "flash_attention", "select_topk"])
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    out = {"tree": sys.argv[2]}
    for P, K in ((176, 15), (400, 15), (176, 1)):
        inp = cs.b1_inputs(3, P, 17, seed=1, K=K)
        out[f"B1 P{P} K{K}"] = timed(
            lambda: beam_decode_attention(**inp, step=17, num_beams=K), flush, host=True)
    g = torch.Generator(device="cuda").manual_seed(1)
    for B in (1, 3):
        q, k, v = (torch.randn(B, 1500, 16, 64, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        out[f"B3 whisper B{B}"] = timed(lambda: flash_attention(q, k, v), flush, host=False)
    x = torch.randn(45, 128256, generator=g, device="cuda") * 4
    out["B5 R45"] = timed(lambda: row_stats_chunkmax(x), flush, host=True)
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
