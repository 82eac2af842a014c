"""Host-to-device input prefetching (port of `omni_avsr_tpu/utils/prefetch.py`).

Overlaps the upload of the next batches with the current step's compute,
the counterpart of the reference's DataLoader worker prefetch
(`data_module.py:156`), one level deeper (device, not host). On the card
each numpy array is copied into page-locked memory and uploaded with
`non_blocking=True` on a side CUDA stream; the consumer's stream waits on
that copy's event when it takes the batch, and `record_stream` keeps the
device memory alive for the consumer's uses. On the CPU it is a plain
`torch.as_tensor`.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Iterator

import numpy as np
import torch


def _is_array(v) -> bool:
    return isinstance(v, (np.ndarray, torch.Tensor))


def device_prefetch(iterator: Iterator[Dict[str, Any]], depth: int = 2,
                    device="cuda") -> Iterator[Dict[str, Any]]:
    """Yield the batches of `iterator` with their arrays on `device`,
    uploading up to `depth` batches ahead. Non-array entries (the static
    trim, gold_text lists) pass through unchanged."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield {k: torch.as_tensor(v).to(device) if _is_array(v) else v
                   for k, v in batch.items()}
        return

    side = torch.cuda.Stream(device=device)

    def put(batch: Dict[str, Any]):
        out = {}
        with torch.cuda.stream(side):
            for k, v in batch.items():
                if _is_array(v):
                    host = torch.as_tensor(v)
                    if host.device.type == "cpu":
                        host = host.pin_memory()
                    out[k] = host.to(device, non_blocking=True)
                else:
                    out[k] = v
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    def take(item):
        batch, ready = item
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(ready)
        for v in batch.values():
            if isinstance(v, torch.Tensor) and v.device.type == "cuda":
                v.record_stream(consumer)
        return batch

    queue: collections.deque = collections.deque()
    for batch in iterator:
        queue.append(put(batch))
        if len(queue) > depth:
            yield take(queue.popleft())
    while queue:
        yield take(queue.popleft())
