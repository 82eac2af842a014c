"""The device trace of a measured window (`--trace 1`): `torch.profiler`
recording device activity only, over the whole window, so that the host's
own pace is disturbed as little as a trace allows.

From its records: busy time as the union of the device operations'
intervals (overlapping kernels are not counted twice), time by operation
name, the time of the kernels a layer's map names (`kernels/<layer>.json`:
name patterns), and the longest idle gaps, each labelled with the harness
span the host was in and the operation the device had just finished.
Host spans are placed on the device clock by a marker launched right
after a synchronise at the window's start.
"""

from __future__ import annotations

import json
import re
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

KERNEL_MAPS = Path(__file__).resolve().parent / "kernels"


class DeviceTrace:
    """Context manager around the measured window."""

    def __init__(self):
        self.ops: List[Tuple[str, float, float]] = []  # (name, start s, end s), host clock
        self.t0 = self.t1 = 0.0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        self._mark = torch.zeros(1, device="cuda")
        self._mark.add_(1.0)  # the first device record: the clocks' anchor
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.ops = _device_ops(self.prof, self.t0)
        self.prof = None
        return False

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        spans = sorted((max(s, self.t0), min(e, self.t1)) for _, s, e in self.ops)
        merged: List[List[float]] = []
        for s, e in spans:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, s, e in self.ops:
            out[n] = out.get(n, 0.0) + (e - s)
        return out

    def layer_s(self, layer: str) -> float:
        """Device seconds of the operations that `kernels/<layer>.json` maps
        to the layer."""
        pats = [re.compile(p) for p in json.loads((KERNEL_MAPS / f"{layer}.json").read_text())
                ["patterns"]]
        return sum(t for n, t in self.by_name().items() if any(p.search(n) for p in pats))

    def breakdown(self, spans: Sequence[Tuple[str, float, float]]) -> Dict:
        """The ten device operations that took most time, and the ten
        longest idle gaps labelled by what the host was doing."""
        top = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:10]
        busy = self.busy_intervals()
        ends = sorted((e, n) for n, _, e in self.ops)
        gaps = []
        prev = self.t0
        for s, e in busy + [(self.t1, self.t1)]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        labelled = []
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            host = [n for n, a, b in spans if a <= mid <= b]
            label = host[-1] if host else "harness: between calls"
            before = _last_before(ends, g0)
            labelled.append([f"{label}; after {_short(before)}" if before else label, g1 - g0])
        return {"device_ops": [[_short(n), t] for n, t in top], "idle_gaps": labelled}


def _last_before(ends, t: float) -> Optional[str]:
    lo, hi = 0, len(ends)
    while lo < hi:
        mid = (lo + hi) // 2
        if ends[mid][0] <= t + 1e-7:
            lo = mid + 1
        else:
            hi = mid
    return ends[lo - 1][1] if lo else None


def _short(name: str, n: int = 120) -> str:
    name = " ".join(name.split())
    return name if len(name) <= n else name[: n - 3] + "..."


def _device_ops(prof, t0_host: float) -> List[Tuple[str, float, float]]:
    """(name, start, end) of every device record, on the host clock: the
    first record (the anchor marker) is placed at `t0_host`."""
    recs = []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()):
            continue
        start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
        dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
        recs.append((e.name(), start, dur))
    if not recs:
        raise RuntimeError("the device trace holds no device record")
    recs.sort(key=lambda r: r[1])
    anchor = recs[0][1]
    return [(n, t0_host + (s - anchor) * 1e-9, t0_host + (s - anchor + d) * 1e-9)
            for n, s, d in recs[1:]]
