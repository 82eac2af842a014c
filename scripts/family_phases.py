#!/usr/bin/env python3
"""chip_smoke.py's AV-HuBERT family phases alone on the GPU: (l) the seq2seq
and CTC fine-tuning steps and decodes, (m) the pre-training step and the
layer-12 dump, and the family's CLIs as subprocesses, each checked as
chip_smoke.py checks it:

    python3 scripts/family_phases.py [l] [m] [cli]

It builds the two flash kernels (B3, B4) first, prints the card's name and
power limit, the phases' lines, then a JSON object of the (l) and (m) rows.
"""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke as cs
    from omni_avsr_tpu_torch import kernels

    if not torch.cuda.is_available():
        print("family_phases: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build_all(["flash_attention", "flash_attention_bwd"])
    work = ROOT / "build" / "family_phases"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    rows = {}
    if "l" in sys.argv[1:]:
        rows.update(cs.s2s_phase())
    if "m" in sys.argv[1:]:
        rows.update(cs.pretrain_phase(work))
    if "cli" in sys.argv[1:]:
        for label, argv in cs.family_cli_runs(work):
            t = time.perf_counter()
            proc = subprocess.run([sys.executable, "-c", cs.RUN_COUNTED,
                                   f"omni_avsr_tpu_torch.cli.{argv[0]}", *argv[1:]], cwd=ROOT,
                                  capture_output=True, text=True, timeout=600)
            if proc.returncode:
                raise RuntimeError(f"{label}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
            launches = json.loads(proc.stdout.splitlines()[-1])
            cs.log("cli", json.dumps(dict(cli=label, wall_s=time.perf_counter() - t,
                                          launches=launches,
                                          **cs.family_cli_result(label, proc.stdout, work))))
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
