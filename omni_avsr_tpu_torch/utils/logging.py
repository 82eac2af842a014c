"""Structured metrics logging (port of `omni_avsr_tpu/utils/logging.py`):
one JSON line per `log` call in `<exp_dir>/<exp_name>/metrics.jsonl`, and
wandb when asked for (imported only then). The reference logs through
WandbLogger and LearningRateMonitor (`train_OmniAVSR.py:35, 52`;
`lightning_OmniAVSR.py:166-169, 187-190`).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricLogger:
    def __init__(self, exp_dir: str, exp_name: str, use_wandb: bool = False,
                 project: str = "omni-avsr-tpu", config: Optional[Dict[str, Any]] = None):
        os.makedirs(os.path.join(exp_dir, exp_name), exist_ok=True)
        self.path = os.path.join(exp_dir, exp_name, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=project, name=exp_name, config=config or {})
            except Exception as e:  # no wandb, or no way to reach it: the JSONL log stays
                print(f"wandb unavailable ({e}); logging to {self.path}")

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        rec = {"step": step, "ts": time.time(),
               **{k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self) -> None:
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
