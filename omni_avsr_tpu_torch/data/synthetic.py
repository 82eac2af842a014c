"""Synthetic AV corpus generator (port of `omni_avsr_tpu/data/synthetic.py`):
short clips (video frames + 16 kHz wav) with known transcripts and their
manifests, so that training and evaluation run end to end offline through
the real file loaders. The same seed writes the same files and manifests
as the JAX package's `generate_corpus` (video as `.npy` where OpenCV is
not installed, as there).
"""

from __future__ import annotations

import os
import wave
from typing import Dict, List, Tuple

import numpy as np

WORDS = (
    "the quick brown fox jumps over a lazy dog and runs far away "
    "hello world speech video model test data sample audio visual"
).split()

# The compositional corpus: every vocabulary word has an audio signature (a
# tone pair) and a video signature (a low-frequency luminance field) laid
# over its time span, and transcripts are per-position binary codes
# (position i is WORDS[2i] or WORDS[2i+1]), distinct across clips and
# splits, so that only the features, not a memorised prefix, give the
# next word.
FRAMES_PER_WORD = 6  # 0.24 s per word at 25 fps; 3840 audio samples


def _word_tones(w: int) -> Tuple[float, float]:
    return 400.0 + 120.0 * w, 450.0 + 133.0 * w  # both < 4 kHz for 24 words


_WORD_PATTERNS: Dict[Tuple[int, int], np.ndarray] = {}


def _word_pattern(w: int, hw: int) -> np.ndarray:
    """The word's luminance pattern in [0, 1]: a 6x6 field of uniform draws
    seeded by the word, bilinearly resized to hw x hw."""
    key = (w, hw)
    if key not in _WORD_PATTERNS:
        rng = np.random.RandomState(7_000 + w)
        small = rng.rand(6, 6)
        xi = np.linspace(0.0, 5.0, hw)
        i0 = np.floor(xi).astype(int)
        i1 = np.minimum(i0 + 1, 5)
        f = xi - i0
        rows = small[i0] * (1 - f)[:, None] + small[i1] * f[:, None]
        full = rows[:, i0] * (1 - f)[None] + rows[:, i1] * f[None]
        lo, hi = full.min(), full.max()
        _WORD_PATTERNS[key] = (full - lo) / max(hi - lo, 1e-9)  # [0, 1]
    return _WORD_PATTERNS[key]


def _synth_audio_words(
    rng: np.random.RandomState, word_ids: List[int], sr: int = 16000
) -> np.ndarray:
    span = FRAMES_PER_WORD * 640
    audio = np.zeros(span * len(word_ids), dtype=np.float64)
    for i, w in enumerate(word_ids):
        t = np.arange(span, dtype=np.float64) / sr
        f1, f2 = _word_tones(w)
        seg = 0.08 * np.sin(2 * np.pi * f1 * t + rng.uniform(0, 2 * np.pi))
        seg += 0.06 * np.sin(2 * np.pi * f2 * t + rng.uniform(0, 2 * np.pi))
        audio[i * span : (i + 1) * span] = seg
    audio += rng.randn(len(audio)) * 0.01
    return audio.astype(np.float32)


def _synth_video_words(
    rng: np.random.RandomState, word_ids: List[int], hw: int = 96
) -> np.ndarray:
    T = FRAMES_PER_WORD * len(word_ids)
    frames = np.empty((T, hw, hw, 3), dtype=np.uint8)
    for i, w in enumerate(word_ids):
        pat = 40.0 + 180.0 * _word_pattern(w, hw)  # (hw, hw) luminance
        for k in range(FRAMES_PER_WORD):
            ti = i * FRAMES_PER_WORD + k
            # small temporal modulation so the 3D stem sees in-word motion
            mod = 1.0 + 0.10 * np.sin(2 * np.pi * k / FRAMES_PER_WORD + w)
            img = np.repeat((pat * mod)[..., None], 3, axis=-1)
            img += rng.randn(hw, hw, 3) * 4.0
            frames[ti] = np.clip(img, 0, 255).astype(np.uint8)
    return frames


def _synth_audio(rng: np.random.RandomState, n: int, sr: int = 16000) -> np.ndarray:
    """Clip-distinct audio: a 3-sinusoid mixture (frequencies, amplitudes
    and phases drawn per clip) plus light noise — a distinct mel signature
    per clip."""
    t = np.arange(n, dtype=np.float64) / sr
    audio = np.zeros(n, dtype=np.float64)
    for _ in range(3):
        f = rng.uniform(150.0, 3800.0)
        a = rng.uniform(0.04, 0.12)
        audio += a * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
    audio += rng.randn(n) * 0.01
    return audio.astype(np.float32)


def _synth_video(rng: np.random.RandomState, T: int, hw: int = 96) -> np.ndarray:
    """Clip-distinct video: a per-clip base colour + oriented spatial
    gradient, temporally modulated at a per-clip rate, plus a moving bright
    block (temporal structure for the 3D stem) and light pixel noise."""
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float64) / hw
    grad = rng.uniform(-1, 1) * xx + rng.uniform(-1, 1) * yy  # (H, W)
    base = rng.uniform(60, 200, size=3)  # RGB
    speed = rng.uniform(0.05, 0.45)
    phase = rng.uniform(0, 2 * np.pi)
    bs = 24  # block size
    bx = rng.randint(0, hw - bs)
    by = rng.randint(0, hw - bs)
    vx, vy = rng.randint(-3, 4), rng.randint(-3, 4)
    frames = np.empty((T, hw, hw, 3), dtype=np.uint8)
    for ti in range(T):
        mod = np.sin(2 * np.pi * speed * ti + phase)
        img = base[None, None, :] + 70.0 * mod * grad[..., None]
        x0 = int(bx + vx * ti) % (hw - bs)
        y0 = int(by + vy * ti) % (hw - bs)
        img[y0:y0 + bs, x0:x0 + bs, :] += 60.0
        img += rng.randn(hw, hw, 3) * 4.0
        frames[ti] = np.clip(img, 0, 255).astype(np.uint8)
    return frames


def _write_wav(path: str, audio: np.ndarray, sr: int = 16000) -> None:
    pcm = np.clip(audio * 32767.0, -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def _write_video(path: str, frames: np.ndarray, fps: float = 25.0) -> str:
    """(T, H, W, 3) RGB or (T, H, W) grayscale uint8 frames -> mp4 through
    OpenCV where it is installed and can write one (grayscale replicated to
    3 channels), else `.npy` of the frames as given (`dataset.load_video`
    reads both); returns the path written."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        T, H, W = frames.shape[:3]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H))
        if vw.isOpened():
            for f in frames:
                vw.write(cv2.cvtColor(f, cv2.COLOR_GRAY2BGR if f.ndim == 2 else cv2.COLOR_RGB2BGR))
            vw.release()
            if os.path.getsize(path) > 0:
                return path
    npy = path[:-4] + ".npy"
    np.save(npy, frames)
    return npy


def generate_corpus(
    out_dir: str,
    n_train: int = 8,
    n_val: int = 2,
    n_test: int = 2,
    min_frames: int = 24,
    max_frames: int = 60,
    min_words: int = 2,
    max_words: int = 5,
    seed: int = 0,
    compositional: bool = False,
) -> Tuple[str, str, str]:
    """Writes clips + manifests; returns (train_csv, val_csv, test_csv).

    compositional=True: AV content is built word-by-word from the per-word
    signature tables above (clip length = 6 frames x n_words; min_frames /
    max_frames are ignored), and transcripts are per-position binary codes
    (see module comment) so prefix memorization cannot beat feature
    reading. The transcript is then LOCALLY decodable from the features —
    the regime the WER-neutrality probe needs (CE -> ~0 and an unseen
    split that is actually learnable: unseen codes are new combinations of
    seen per-position words)."""
    rng = np.random.RandomState(seed)
    ds = "synth"
    clip_dir = os.path.join(out_dir, ds)
    os.makedirs(clip_dir, exist_ok=True)

    used_codes: set = set()

    def draw_code(n_words: int) -> List[int]:
        """Distinct-per-corpus binary code -> word ids (bit i of the code
        selects WORDS[2i] vs WORDS[2i+1]; needs 2*n_words <= len(WORDS))."""
        assert 2 * n_words <= len(WORDS), "vocab too small for code corpus"
        for _ in range(10_000):
            code = int(rng.randint(0, 2 ** n_words))
            if code not in used_codes:
                used_codes.add(code)
                return [2 * i + ((code >> i) & 1) for i in range(n_words)]
        raise ValueError("code space exhausted: reduce clips or raise words")

    def make_split(name: str, n: int) -> str:
        rows = []
        for i in range(n):
            n_words = int(rng.randint(min_words, max_words + 1))
            if compositional:
                word_ids = draw_code(n_words)
                text = " ".join(WORDS[w] for w in word_ids)
                frames = _synth_video_words(rng, word_ids)
                audio = _synth_audio_words(rng, word_ids)
                T = frames.shape[0]
            else:
                # structured, clip-distinct content (sinusoid mixtures,
                # oriented gradients): a tower-visible signature per clip
                T = int(rng.randint(min_frames, max_frames + 1))
                frames = _synth_video(rng, T)
                audio = _synth_audio(rng, T * 640)
                text = " ".join(rng.choice(WORDS) for _ in range(n_words))
            base = f"{name}_{i:04d}"
            video_path = _write_video(os.path.join(clip_dir, base + ".mp4"), frames)
            _write_wav(os.path.join(clip_dir, base + ".wav"), audio)
            rel = os.path.basename(video_path)
            rows.append(f"{ds},{rel},{T},0,{text}")
        csv_path = os.path.join(out_dir, f"{name}.csv")
        with open(csv_path, "w") as f:
            f.write("\n".join(rows) + "\n")
        return csv_path

    return make_split("train", n_train), make_split("val", n_val), make_split("test", n_test)
