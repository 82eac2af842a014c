"""Tracing, step timing and NaN hunting (the subset of
`omni_avsr_tpu/utils/profiling.py` that the training CLI uses): `trace`
records a `torch.profiler` trace (host and, on the card, CUDA activity) of
the steps inside it as a Chrome trace, `StepTimer` keeps a rolling mean of
the host time between steps, and `find_nonfinite` names the leaves of a
tensor tree that hold a NaN or an Inf.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Iterator, List, Optional

import torch


@contextlib.contextmanager
def trace(profile_dir: Optional[str], device="cuda") -> Iterator[None]:
    """Profile the block into `<profile_dir>/trace_<pid>_<ns>.json`
    (CUDA activity too when `device` is a CUDA device); nothing when
    `profile_dir` is None."""
    if not profile_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir,
                                          f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Rolling mean of the host wall clock between `tick` calls."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: List[float] = []
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        return dt

    @property
    def mean(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0


def find_nonfinite(tree: Any, prefix: str = "") -> List[str]:
    """Dotted paths of the floating leaves that hold a NaN or an Inf."""
    if isinstance(tree, dict):
        bad: List[str] = []
        for k, v in tree.items():
            bad += find_nonfinite(v, f"{prefix}.{k}" if prefix else k)
        return bad
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        if not bool(torch.isfinite(tree.detach()).all()):
            return [prefix]
    return []
