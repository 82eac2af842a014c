"""Checkpoints of the train state with `torch.save`, and last-N weight
averaging (port of `omni_avsr_tpu/train/checkpoint.py`).

  - the reference keeps the latest K checkpoints (`train_OmniAVSR.py:27-34`)
    and resumes from one (`:345-349, 418`);
  - after training it averages the last N (`utils/avg_checkpoints.py:14-44`).
A checkpoint holds {step, trainable masters, optimizer state}, moved to the
CPU; the frozen weights come from the base checkpoints and are not
duplicated. Files are `step_<8 digits>.pt` in one directory.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional

import torch

from .state import TrainState, tree_map


def _to_cpu(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        items = [_to_cpu(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    return x


def list_checkpoints(ckpt_dir: str) -> List[str]:
    if not os.path.isdir(ckpt_dir):
        return []
    names = sorted(n for n in os.listdir(ckpt_dir) if n.startswith("step_") and n.endswith(".pt"))
    return [os.path.join(os.path.abspath(ckpt_dir), n) for n in names]


def save_checkpoint(ckpt_dir: str, step: int, state: TrainState, keep: int = 4) -> str:
    """Write `state` as step_<step>.pt and keep only the newest `keep`."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}.pt")
    tmp = path + ".tmp"
    torch.save({"step": state.step, "trainable": _to_cpu(state.trainable),
                "opt_state": _to_cpu(state.opt_state)}, tmp)
    os.replace(tmp, path)
    for old in list_checkpoints(ckpt_dir)[:-keep] if keep > 0 else []:
        os.remove(old)
    return path


def restore_checkpoint(path: str, device="cuda") -> TrainState:
    """The saved state, its tensors on `device` (masters require grad): the
    card unless the caller asks for the CPU."""
    raw = torch.load(path, map_location=device, weights_only=False)
    trainable = tree_map(lambda x: x.requires_grad_(True), raw["trainable"])
    return TrainState(raw["step"], trainable, raw["opt_state"])


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    ckpts = list_checkpoints(ckpt_dir)
    return ckpts[-1] if ckpts else None


def average_last_n(ckpt_dir: str, n: int):
    """Arithmetic mean of the trainable trees of the last n checkpoints, in
    f64 and returned in f32 (`ensemble_original`,
    `utils/avg_checkpoints.py:34-44`)."""
    ckpts = list_checkpoints(ckpt_dir)[-n:]
    assert ckpts, f"no checkpoints in {ckpt_dir}"
    acc = None
    for path in ckpts:
        tree = tree_map(lambda x: x.detach().double(), restore_checkpoint(path, device="cpu").trainable)
        acc = tree if acc is None else _add(acc, tree)
    return tree_map(lambda x: (x / len(ckpts)).float(), acc)


def _add(a: dict, b: dict) -> dict:
    return {k: _add(v, b[k]) if isinstance(v, dict) else v + b[k] for k, v in a.items()}
