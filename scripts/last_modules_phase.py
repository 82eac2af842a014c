#!/usr/bin/env python3
"""chip_smoke.py's phase (q) alone on the card, after building the kernels:

    python3 scripts/last_modules_phase.py

It runs `chip_smoke.py::last_modules_phase`: `llm_loss` forward and
backward on the full-width Llama-3.2-1B at B 4 x T 512 (B3 and B4 counted,
the kernel route held against the plain one), `llm_logits` with a padding
mask against the CPU, lightweight and dynamic convolutions at
lightconv_wmt_en_de_big's width against float64 on the CPU, and
`checkify_step` around the full-width train step. It prints the card's
name and power limit first, the phase's log lines, and
"LAST_MODULES_PHASE {json}" with the rows last; it exits non-zero without
a CUDA device.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("last_modules_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from omni_avsr_tpu_torch import kernels

    print(cs.card(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py's main sets them
    torch.backends.cudnn.allow_tf32 = False
    kernels.build_all(sorted(p.stem for p in kernels.CSRC.glob("*.cu")))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rows = cs.last_modules_phase(flush)
    print("LAST_MODULES_PHASE " + json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
