"""Whisper log-mel frontend on the device (port of
`omni_avsr_tpu/ops/audio_frontend.py`; HF WhisperFeatureExtractor numerics).

Periodic Hann window, n_fft 400, hop 160, centred reflect padding, power
spectrum through a real DFT written as two matmuls, 80 slaney mel filters,
log10(max(mel, 1e-10)), per-sample clamp at max - 8, then (x + 4) / 4.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
N_MELS = 80
CHUNK_SAMPLES = 30 * SAMPLE_RATE  # 480000
NUM_FRAMES = CHUNK_SAMPLES // HOP  # 3000


def hertz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hertz, min_log_mel = 1000.0, 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    above = freq >= min_log_hertz
    return np.where(above, min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hertz) * logstep, mels)


def mel_to_hertz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    min_log_hertz, min_log_mel = 1000.0, 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    above = mels >= min_log_mel
    return np.where(above, min_log_hertz * np.exp(logstep * (mels - min_log_mel)), freq)


@functools.lru_cache(maxsize=1)
def mel_filter_bank() -> np.ndarray:
    """Triangular slaney-normalised mel filterbank, (201, 80) f32."""
    fft_freqs = np.linspace(0.0, SAMPLE_RATE / 2.0, N_FFT // 2 + 1)
    mel_pts = np.linspace(hertz_to_mel_slaney(np.array(0.0)),
                          hertz_to_mel_slaney(np.array(8000.0)), N_MELS + 2)
    hz_pts = mel_to_hertz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[None, :] - fft_freqs[:, None]
    down = -ramps[:, :-2] / fdiff[None, :-1]
    up = ramps[:, 2:] / fdiff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    fb = fb * (2.0 / (hz_pts[2:] - hz_pts[:-2]))[None, :]
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=1)
def _hann_window() -> np.ndarray:
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT))).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _dft_matrices() -> Tuple[np.ndarray, np.ndarray]:
    """Real DFT as two (n_fft, n_fft//2+1) matmul operands (cos, -sin)."""
    k = np.arange(N_FFT // 2 + 1)[None, :]
    t = np.arange(N_FFT)[:, None]
    ang = 2.0 * np.pi * t * k / N_FFT
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def log_mel_spectrogram(
    audio: torch.Tensor,  # (B, S) waveform at 16 kHz
    audio_lengths: Optional[torch.Tensor] = None,  # (B,) valid samples
    num_frames: int = NUM_FRAMES,
) -> torch.Tensor:
    """Whisper log-mel features, (B, num_frames, 80) f32. A num_frames below
    3000 computes only that window (the "bucket" mode of models/omni.py);
    its frames equal those of the 30 s computation."""
    B, S = audio.shape
    dev = audio.device
    chunk = num_frames * HOP
    audio = audio.float()
    if audio_lengths is not None:
        valid = torch.arange(S, device=dev)[None, :] < audio_lengths[:, None]
        audio = torch.where(valid, audio, torch.zeros((), device=dev))
    if S < chunk:
        audio = torch.nn.functional.pad(audio, (0, chunk - S))
    else:
        audio = audio[:, :chunk]
    pad = N_FFT // 2
    x = torch.nn.functional.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
    idx = (torch.arange(num_frames + 1, device=dev)[:, None] * HOP
           + torch.arange(N_FFT, device=dev)[None, :])
    windowed = x[:, idx] * torch.from_numpy(_hann_window()).to(dev)
    cos_m, sin_m = (torch.from_numpy(m).to(dev) for m in _dft_matrices())
    re = windowed @ cos_m
    im = windowed @ sin_m
    power = (re.square() + im.square())[:, :-1]  # HF drops the last frame
    mel = power @ torch.from_numpy(mel_filter_bank()).to(dev)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    max_val = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, max_val - 8.0)
    return (log_spec + 4.0) / 4.0


def whisper_token_len(audio_samples: Union[int, torch.Tensor]) -> Union[int, torch.Tensor]:
    """max(len/16000*50, 25) Whisper tokens (`modeling_OmniAVSR.py:536-537`)."""
    if isinstance(audio_samples, (int, np.integer)):
        return max(int(audio_samples / SAMPLE_RATE * 50), 25)
    return torch.clamp((audio_samples * 50) // SAMPLE_RATE, min=25)
