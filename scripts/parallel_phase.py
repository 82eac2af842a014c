#!/usr/bin/env python3
"""chip_smoke.py's phase (p) alone on the card, after building the kernels:

    python3 scripts/parallel_phase.py

It runs `chip_smoke.py::parallel_phase`: NCCL at world size 1 at full width
(an FSDP train step and a `Transcriber(mesh=...)` batch, each held against
the meshless one) and each rank's B1, B2 and B5 launches of a tp 2 and 4
mesh at the shard shapes of Llama-3.2-1B and Qwen2.5-7B, held against the
unsharded kernel. It prints the card's name and power limit first, the
phase's log lines, and "PARALLEL_PHASE {json}" with the rows last; it
exits non-zero without a CUDA device.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("parallel_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from omni_avsr_tpu_torch import kernels

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    kernels.build_all(sorted(p.stem for p in kernels.CSRC.glob("*.cu")))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rows = cs.parallel_phase(flush, cs.make_items((160, 160, 160), seed=0))
    print("PARALLEL_PHASE " + json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
