"""Closed-loop batches: one caller sends a batch of requests to the serving
API (`System.serve`, i.e. `Transcriber.transcribe_many`) and sends the
next when it returns. The window runs whole passes over the pool: it ends
with the first pass that completes after `seconds`, so every run times
whole passes, each the same work.

Parameters (the traffic file): `batch_size`, `modality`, `lengths` (see
`media.lengths`), `beams`, `pool_batches` (batches made at set-up and
cycled), `population_seed` (the clip lengths and how they fall into
batches, drawn in order as a test set's manifest lists them; every run
seed serves these batches). The run seed orders the batches of a pass and
the clips of a batch, and draws the media. Each batch is served at its
own window (the program's padding class of its longest clip).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from .. import media
from ..reference.omni import ladder


def prepare(p: dict, seed: int, seconds: float, device, cfg=None) -> Dict:
    B, n = p["batch_size"], p["batch_size"] * p["pool_batches"]
    frames = media.lengths(np.random.default_rng(p["population_seed"]), p["lengths"], n)
    rng = np.random.default_rng(seed)
    batches = [rng.permutation(frames[i:i + B]) for i in rng.permutation(range(0, n, B))]
    reqs = [media.Req(i, p["modality"], p["beams"], int(f))
            for i, f in enumerate(np.concatenate(batches))]
    media.fill_media(reqs, seed, device)
    return {"pool": [reqs[i:i + B] for i in range(0, n, B)], "p": p}


def warmup(system, state: Dict) -> None:
    """Every batch shape the window sends, once: a pool batch of each
    padded window (the ladder class of its longest clip)."""
    p = state["p"]
    by_window = {ladder(max(r.frames for r in b), 32): b for b in state["pool"]}
    for batch in by_window.values():
        system.serve([r.item for r in batch], p["modality"], p["beams"])


def window(system, state: Dict, seconds: float) -> Dict:
    p = state["p"]
    pool = state["pool"]
    done: List[media.Req] = []
    batches = []
    rid = 0
    t_start = time.perf_counter()
    i = 0
    while i % len(pool) or time.perf_counter() - t_start < seconds:
        src = pool[i % len(pool)]
        batch = [media.Req(rid + j, r.modality, r.beams, r.frames, dict(r.item))
                 for j, r in enumerate(src)]
        rid += len(batch)
        for r in batch:
            system.tag(r.rid, r.item)
        t0 = time.perf_counter()
        system.serve([r.item for r in batch], p["modality"], p["beams"])
        t1 = time.perf_counter()
        batches.append({"t0": t0, "t1": t1, "rids": [r.rid for r in batch]})
        done += batch
        i += 1
    t_end = time.perf_counter()
    return {"t_start": t_start, "t_end": t_end, "requests": done, "batches": batches,
            "attempted": len(done)}
