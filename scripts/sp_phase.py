#!/usr/bin/env python3
"""chip_smoke.py's phase (r) alone on the card, after building the kernels:

    python3 scripts/sp_phase.py

It runs `chip_smoke.py::sp_phase`: a probe of gloo's and the port's
collectives on card tensors in two ranks that share the card, then one
train step of the MoE flagship at tp 2 with and without sequence
parallelism on two gloo ranks, and of the flagship on Qwen2.5-0.5B at tp 4
with sequence parallelism (a replicated attention) on four, each against
the meshless step in this process. It prints the card's name and power
limit first, the phase's log lines, and "SP_PHASE {json}" with the rows
last; it exits non-zero without a CUDA device.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sp_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from omni_avsr_tpu_torch import kernels

    print(cs.card(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py's main sets them
    torch.backends.cudnn.allow_tf32 = False
    kernels.build_all(sorted(p.stem for p in kernels.CSRC.glob("*.cu")))
    rows = cs.sp_phase()
    print("SP_PHASE " + json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
