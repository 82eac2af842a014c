"""Babble-noise bank for AddNoise augmentation (port of
`omni_avsr_tpu/data/noise.py`): a numpy waveform that the engine moves to
the device.

The reference bundles `datamodule/babble_noise.wav` (16 kHz babble,
`transforms.py:10-12, 60-71`). We load a user-provided wav when configured;
without one we synthesise a deterministic speech-shaped babble surrogate
(sum of amplitude-modulated, band-passed noise streams) so the pipeline is
runnable offline. For strict reference parity, point `noise_path` at the
original babble wav.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def load_noise_bank(noise_path: Optional[str], seconds: float = 60.0, seed: int = 1234) -> np.ndarray:
    if noise_path:
        from .dataset import load_audio

        return load_audio(noise_path)
    import warnings

    warnings.warn(
        "no --noise-path given: using a SYNTHESIZED speech-shaped babble "
        "surrogate, not the reference `babble_noise.wav` — SNR-sweep WER "
        "will not be comparable to the paper's noise condition"
    )
    return synth_babble(seconds, seed)


def synth_babble(seconds: float = 60.0, seed: int = 1234, sr: int = 16000) -> np.ndarray:
    """Speech-shaped babble surrogate: N talkers = N modulated pink-ish
    noise streams band-limited to ~100-4000 Hz."""
    rng = np.random.RandomState(seed)
    n = int(seconds * sr)
    out = np.zeros(n, np.float64)
    t = np.arange(n) / sr
    for talker in range(6):
        white = rng.randn(n)
        spec = np.fft.rfft(white)
        freqs = np.fft.rfftfreq(n, 1.0 / sr)
        shape = np.where(
            (freqs > 80) & (freqs < 4500),
            1.0 / np.sqrt(np.maximum(freqs, 120.0)),
            0.0,
        )
        stream = np.fft.irfft(spec * shape, n)
        # syllabic amplitude modulation ~3-7 Hz
        rate = 3.0 + rng.rand() * 4.0
        phase = rng.rand() * 2 * np.pi
        env = 0.55 + 0.45 * np.sin(2 * np.pi * rate * t + phase)
        out += stream * env
    out /= np.max(np.abs(out)) + 1e-9
    return (out * 0.3).astype(np.float32)
