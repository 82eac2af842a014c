"""Requests and their media, made from the run's seed.

A traffic mix fixes a population of request sizes with its own
`population_seed`, so every run seed serves the same work; the run seed
orders it and draws the media (16 kHz audio, 25 fps mouth frames of
96 x 96 x 3), in two large draws on the device, copied to the host once.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

SAMPLES_PER_FRAME = 640  # 16 kHz audio against 25 fps video
FRAME_SHAPE = (96, 96, 3)


@dataclass
class Req:
    """One request: its id, modality, beams, clip length in frames and, once
    made, its media (`item`, the serving API's {"audio", "video"} dict)."""

    rid: int
    modality: str
    beams: int
    frames: int
    item: Dict[str, Optional[np.ndarray]] = field(default_factory=dict)

    @property
    def audio_s(self) -> float:
        return self.frames / 25.0


def lengths(rng: np.random.Generator, spec: dict, n: int) -> np.ndarray:
    """n clip lengths in frames, log-normal: {"dist": "lognormal", "mean_s",
    "sigma", "lo", "hi"} (the mean in seconds, bounds in frames,
    inclusive)."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"length distribution {spec['dist']!r}")
    median = spec["mean_s"] * 25.0 * np.exp(-spec["sigma"] ** 2 / 2)
    x = rng.lognormal(np.log(median), spec["sigma"], size=n)
    return np.clip(np.round(x), spec["lo"], spec["hi"]).astype(np.int64)


def fill_media(reqs: List[Req], seed: int, device) -> None:
    """Each request's media from `seed`: white noise at 0.1 RMS for the
    audio, uniform bytes for the frames, drawn on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    na = sum(r.frames for r in reqs if r.modality != "video") * SAMPLES_PER_FRAME
    nv = sum(r.frames for r in reqs if r.modality != "audio") * int(np.prod(FRAME_SHAPE))
    audio = (torch.randn(max(na, 1), generator=gen, device=device) * 0.1).cpu().numpy()
    video = torch.randint(0, 256, (max(nv, 1),), generator=gen, device=device,
                          dtype=torch.uint8).cpu().numpy()
    ia = iv = 0
    for r in reqs:
        item: Dict[str, Optional[np.ndarray]] = {}
        if r.modality != "video":
            n = r.frames * SAMPLES_PER_FRAME
            item["audio"] = audio[ia:ia + n]
            ia += n
        if r.modality != "audio":
            n = r.frames * int(np.prod(FRAME_SHAPE))
            item["video"] = video[iv:iv + n].reshape((r.frames,) + FRAME_SHAPE)
            iv += n
        r.item = item
