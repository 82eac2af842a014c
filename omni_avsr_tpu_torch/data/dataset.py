"""Host-side AV dataset: manifest parsing and clip loading (port of
`omni_avsr_tpu/data/dataset.py`; reference `datamodule/av_dataset.py:14-118`):
  - manifest rows `dataset_name,rel_path,input_length,<unused>,text`
  - video from `.npy` (synthetic corpora) or mp4 through OpenCV, imported
    only when an mp4 is read; wav through the standard library's `wave`
  - AV sync: `cut_or_pad(audio, T_video * 640)` (640 = 16 kHz / 25 fps)

Raw uint8 video and f32 waveforms come back as numpy arrays; augmentation
runs on the device in the engine (`ops/augment.py`).
"""

from __future__ import annotations

import os
import wave
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

RATE_RATIO = 640  # audio samples per video frame


@dataclass
class ManifestEntry:
    dataset: str
    rel_path: str
    input_length: int
    text: str

    def path(self, root_dir: str) -> str:
        return os.path.join(root_dir, self.dataset, self.rel_path)


def load_manifest(label_path: str) -> List[ManifestEntry]:
    entries = []
    with open(label_path) as f:
        for line in f.read().splitlines():
            if not line.strip():
                continue
            dataset, rel_path, input_length, _, text = line.split(",", 4)
            entries.append(ManifestEntry(dataset, rel_path, int(input_length), text))
    return entries


def load_video(path: str) -> np.ndarray:
    """mp4 -> (T, H, W, 3) uint8 via OpenCV (.npy accepted for synthetic
    corpora, data/synthetic.py)."""
    if path.endswith(".npy"):
        return np.load(path)
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    return np.stack(frames)


def load_audio(path: str) -> np.ndarray:
    """wav (same basename as the mp4) -> (S,) f32 in [-1, 1]."""
    wav_path = path[:-4] + ".wav" if path.endswith((".mp4", ".npy")) else path
    with wave.open(wav_path, "rb") as w:
        if w.getframerate() != 16000:
            raise ValueError(f"{wav_path}: expected 16 kHz, got {w.getframerate()}")
        n = w.getnframes()
        raw = w.readframes(n)
        width = w.getsampwidth()
        channels = w.getnchannels()
    if width == 2:
        audio = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        audio = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if channels > 1:
        audio = audio.reshape(-1, channels)[:, 0]
    return audio


def cut_or_pad(audio: np.ndarray, size: int) -> np.ndarray:
    if len(audio) < size:
        return np.pad(audio, (0, size - len(audio)))
    return audio[:size]


class AVDataset:
    """Indexable host dataset yielding raw sample dicts."""

    def __init__(
        self,
        root_dir: str,
        label_path: str,
        modality: str,
        rate_ratio: int = RATE_RATIO,
        downsample_video: Optional[int] = None,
    ):
        self.root_dir = root_dir
        self.modality = modality
        self.rate_ratio = rate_ratio
        # non-matryoshka single-rate video is pre-trimmed to a rate multiple
        # (`av_dataset.py:93-94, 111-112`)
        self.downsample_video = downsample_video if downsample_video not in (None, 1) else None
        self.entries = load_manifest(label_path)
        self.input_lengths = [e.input_length for e in self.entries]

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, idx: int) -> Dict:
        e = self.entries[idx]
        path = e.path(self.root_dir)
        out: Dict = {"text": e.text}
        if self.modality in ("video", "audiovisual"):
            video = load_video(path)
            if self.downsample_video:
                t = len(video) // self.downsample_video * self.downsample_video
                video = video[:t]
            out["video"] = video
        if self.modality in ("audio", "audiovisual"):
            audio = load_audio(path)
            if self.modality == "audiovisual":
                audio = cut_or_pad(audio, len(out["video"]) * self.rate_ratio)
            out["audio"] = audio
        return out
