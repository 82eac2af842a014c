#!/usr/bin/env python3
"""chip_smoke.py's multi-rank phase ((r), (u), (v)) alone on the card, after
building the kernels:

    python3 scripts/multirank_phase.py [case ...]

It runs `chip_smoke.py::multirank_phase` on gloo ranks that share the card:
probes of gloo's collectives and of its point-to-point pair on card
tensors, then the cases named (all when none is): r1 (the MoE flagship's
train step at tp 2 with and without sequence parallelism), u1 (the
flagship with a 128256-token vocabulary served by `Transcriber(mesh=...)`
at tp 2 and tp 4), u2 (Qwen2.5-7B served at tp 2), v1 (the flagship's
train step at dp 2, with and without FSDP), v2 (the MoE flagship at ep 2),
pp (the flagship at pp 2, run only when the point-to-point probe passed)
and r2 (the flagship on Qwen2.5-0.5B at tp 4 with sequence parallelism),
each against the meshless run in this process. It prints the card's name
and power limit first, the phase's log lines, and "MULTIRANK_PHASE {json}"
with the rows last; it exits non-zero without a CUDA device or when a case
fails.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CASES = ("r1", "u1", "u2", "v1", "v2", "pp", "r2")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("multirank_phase: no CUDA device", file=sys.stderr)
        return 2
    unknown = set(argv) - set(CASES)
    if unknown:
        print(f"multirank_phase: unknown cases {sorted(unknown)}; the cases are {CASES}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from omni_avsr_tpu_torch import kernels

    print(cs.card(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py's main sets them
    torch.backends.cudnn.allow_tf32 = False
    kernels.build_all(sorted(p.stem for p in kernels.CSRC.glob("*.cu")))
    rows = cs.multirank_phase(tuple(argv) or None)
    print("MULTIRANK_PHASE " + json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
