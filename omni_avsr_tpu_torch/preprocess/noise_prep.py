"""Noise-bank construction: MUSAN/LRS3-style babble mixing + clip splitting
(port of `omni_avsr_tpu/preprocess/noise_prep.py`, the same files bit for
bit). Re-implements the reference's noise preparation semantics without SLURM:

  - `mix_wavs`: trim every source to the shortest, average, int16 — exactly
    the reference's mix rule (`av_hubert/avhubert/preparation/
    musan_prepare.py:38-46`, `lrs3_noise.py:12-19`).
  - `make_babble_wav`: LRS3-style single `noise.wav` — pick `num_per_mixture`
    clips longer than `min_seconds` and mix (`lrs3_noise.py:35-48`).
  - `make_musan_babble`: MUSAN-style many-mixture bank with a speaker-held-
    out train/valid/test split and per-mixture `np.random.seed(i)`
    (`musan_prepare.py:48-99`).
  - `split_clips`: split raw audios into fixed-duration segments
    (`musan_prepare.py:17-36`, 10 s "short-musan" clips).

All IO is stdlib `wave` (16 kHz mono int16), matching the corpus format the
reference's scipy.io.wavfile calls assume.
"""

from __future__ import annotations

import os
import wave
from typing import Dict, List, Sequence, Tuple

import numpy as np

SR = 16000


def read_wav_int16(path: str) -> np.ndarray:
    with wave.open(path, "rb") as w:
        assert w.getframerate() == SR, f"expected 16 kHz, got {w.getframerate()} ({path})"
        raw = w.readframes(w.getnframes())
        width, channels = w.getsampwidth(), w.getnchannels()
    if width != 2:
        raise ValueError(f"expected int16 wav, got width {width} ({path})")
    data = np.frombuffer(raw, dtype=np.int16)
    if channels > 1:
        data = data.reshape(-1, channels)[:, 0]
    return data


def write_wav_int16(path: str, data: np.ndarray) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(np.asarray(data, np.int16).tobytes())
    return path


def wav_duration_frames(path: str) -> int:
    with wave.open(path, "rb") as w:
        return w.getnframes()


def mix_wavs(paths: Sequence[str]) -> np.ndarray:
    """Trim to the shortest source, average, int16 (reference mix_audio)."""
    data = [read_wav_int16(p) for p in paths]
    min_len = min(len(x) for x in data)
    return np.stack([x[:min_len] for x in data]).mean(axis=0).astype(np.int16)


def make_babble_wav(
    wav_paths: Sequence[str],
    out_wav: str,
    num_per_mixture: int = 30,
    min_seconds: float = 15.0,
    seed: int = 0,
) -> Tuple[str, int]:
    """LRS3-style babble: one noise.wav mixed from `num_per_mixture` clips
    longer than `min_seconds` (`lrs3_noise.py:35-48`). Returns (path, n_mixed)."""
    eligible = [p for p in wav_paths if wav_duration_frames(p) > min_seconds * SR]
    if not eligible:
        raise ValueError(
            f"no source wavs longer than {min_seconds}s out of {len(wav_paths)}")
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(eligible))[:num_per_mixture]
    picked = [eligible[i] for i in idx]
    write_wav_int16(out_wav, mix_wavs(picked))
    # companion manifests, one abs path per line (`lrs3_noise.py:46-48`)
    for split in ("valid", "test"):
        tsv = os.path.join(os.path.dirname(os.path.abspath(out_wav)), f"{split}.tsv")
        with open(tsv, "w") as f:
            f.write(os.path.abspath(out_wav) + "\n")
    return out_wav, len(picked)


def group_by_speaker(wav_paths: Sequence[str]) -> Dict[str, List[str]]:
    """MUSAN speech naming: `speech-<lang>-<spk>-NNNN.wav` -> speaker =
    basename minus the trailing index (`musan_prepare.py:50-56`)."""
    spk2wav: Dict[str, List[str]] = {}
    for p in wav_paths:
        spk = "-".join(os.path.basename(p).split("-")[:-1]) or os.path.basename(p)
        spk2wav.setdefault(spk, []).append(p)
    return spk2wav


def make_musan_babble(
    wav_paths: Sequence[str],
    out_dir: str,
    num_per_mixture: int = 30,
    counts: Dict[str, int] = None,
    seed: int = 0,
) -> Dict[str, List[str]]:
    """MUSAN-style bank: speaker-held-out 80/10/10 split, then per split N
    mixtures of `num_per_mixture` random files from that split's speakers
    (`musan_prepare.py:68-99`; per-mixture np.random.seed(i))."""
    counts = counts or {"train": 8000, "valid": 1000, "test": 1000}
    spk2wav = group_by_speaker(wav_paths)
    speakers = sorted(spk2wav)
    rng = np.random.RandomState(seed)
    rng.shuffle(speakers)
    n_train = int(len(speakers) * 0.8)
    n_valid = int(len(speakers) * 0.1)
    split_speakers = {
        "train": speakers[:n_train],
        "valid": speakers[n_train:n_train + n_valid],
        "test": speakers[n_train + n_valid:],
    }
    os.makedirs(out_dir, exist_ok=True)
    outputs: Dict[str, List[str]] = {}
    for split, spks in split_speakers.items():
        fns: List[str] = []
        for s in spks:
            fns.extend(spk2wav[s])
        if not fns:
            outputs[split] = []
            continue
        # speaker list alongside the bank (`musan_prepare.py:62-66`)
        with open(os.path.join(out_dir, f"spk.{split}"), "w") as f:
            f.write("\n".join(spks) + "\n")
        outs = []
        for i in range(counts.get(split, 0)):
            mix_rng = np.random.RandomState(i)  # reference: np.random.seed(i)
            perm = mix_rng.permutation(len(fns))[:num_per_mixture]
            out = os.path.join(out_dir, f"{split}-{str(i + 1).zfill(5)}.wav")
            write_wav_int16(out, mix_wavs([fns[x] for x in perm]))
            outs.append(out)
        outputs[split] = outs
    return outputs


def split_clips(
    wav_paths: Sequence[str],
    out_dir: str,
    seconds: float = 10.0,
) -> List[str]:
    """Split raw audios into `seconds`-long clips (`musan_prepare.py:17-36`);
    clips already short enough are left alone (not copied)."""
    outs: List[str] = []
    n = int(seconds * SR)
    for p in wav_paths:
        data = read_wav_int16(p)
        if len(data) <= n:
            continue
        base = os.path.splitext(os.path.basename(p))[0]
        num_split = int(np.ceil(len(data) / n))
        for i in range(num_split):
            out = os.path.join(out_dir, f"{base}-{i}.wav")
            outs.append(write_wav_int16(out, data[i * n:(i + 1) * n]))
    return outs
