#!/usr/bin/env python3
"""Times B1 (beam-decode attention) and B7 (the fused ResNet conv) of one
checkout of the port on the GPU, for comparing two checkouts in one call:

    python3 scripts/ab_b1_b7.py <checkout root> <label>

Run it once per checkout in turns (parent, change, change, parent), so
that both are measured on the same card. It imports `chip_smoke.py` and
`omni_avsr_tpu_torch` from the given root, builds that checkout's two
kernel sources there, and prints one line "AB {json}": B1 at chip_smoke.py's
three timed shapes (B 3, step 17; P 176 / 400 with 15 beams, P 176 with
1), device ms with a cold L2 and host ms per call (the median of 5 x 200
back-to-back calls), and B7's device ms at each trunk geometry of 480
frames with the sum over one trunk.
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
from omni_avsr_tpu_torch.ops.conv_block import conv2d_fused  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_b1_b7: no CUDA device", file=sys.stderr)
        return 2
    if not Path(kernels.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {kernels.__file__}, not the checkout at {root}")
    kernels.build_all(["beam_attention", "conv_block"])
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    out = {"tree": sys.argv[2]}
    for P, K in ((176, 15), (400, 15), (176, 1)):
        inp = cs.b1_inputs(3, P, 17, seed=1, K=K)
        fn = lambda: beam_decode_attention(**inp, step=17, num_beams=K)  # noqa: E731
        hosts = sorted(cs.host_ms(fn, iters=200) for _ in range(5))
        out[f"B1 P{P} K{K}"] = dict(ms=cs.time_ms(fn, flush), host_ms=hosts[2], host_ms_all=hosts)
    trunk = 0.0
    for label, Fr, H, Cin, Cout, k, stride, pad, _, act, res, count in cs.trunk_convs(480):
        g = torch.Generator(device="cuda").manual_seed(1)
        Ho = (H + 2 * pad - k) // stride + 1
        x = (torch.randn(Fr, H, H, Cin, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
        w = (torch.randn(k, k, Cin, Cout, generator=g, device="cuda") * 0.05).to(torch.bfloat16)
        scale = torch.rand(Cout, generator=g, device="cuda") + 0.5
        bias = torch.randn(Cout, generator=g, device="cuda") * 0.1
        a = torch.rand(Cout, generator=g, device="cuda") * 0.25 if act else None
        r = (torch.randn(Fr, Ho, Ho, Cout, generator=g, device="cuda").to(torch.bfloat16)
             if res else None)
        ms = cs.time_ms(lambda: conv2d_fused(x, w, stride, pad, scale, bias, a, r), flush)
        out[f"B7 {label}"] = ms
        trunk += count * ms
    out["B7 trunk"] = trunk
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
