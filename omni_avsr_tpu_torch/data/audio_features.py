"""Host-side stacked log-filterbank features for the AV-HuBERT audio branch
(the port's own numpy copy of `omni_avsr_tpu/data/audio_features.py`).

Reference pipeline (`av_hubert/avhubert/hubert_dataset.py:286-287, 351-353`):
  logfbank(wav, 16 kHz)            26-dim log mel filterbanks @ 100 Hz
                                   (python_speech_features defaults: 25 ms
                                   rectangular frames, 10 ms hop, preemphasis
                                   0.97, NFFT 512, HTK mel scale)
  stacker(feats, 4)                zero-pad to a multiple of 4 frames, then
                                   concat 4 consecutive frames -> 104-d @ 25 Hz,
                                   time-aligned 1:1 with the video frames
  F.layer_norm(feats, feats.shape[1:])   per-frame normalization over the
                                   104 features (normalize=True for the
                                   AV-HuBERT Large recipes)

For T video frames (T*640 samples) logfbank yields 4T-1 frames, so the
stacker pads exactly one frame and returns exactly T stacked frames.
"""

from __future__ import annotations

import numpy as np

SR = 16000
STACK = 4  # 100 Hz feature rate -> 25 Hz video rate
N_FILT = 26
_NFFT = 512
_FRAME_LEN = 400  # 25 ms
_HOP = 160  # 10 ms
_PREEMPH = 0.97


def _mel_filters(n_filt: int, nfft: int, sr: int) -> np.ndarray:
    """HTK-mel triangular filterbank (python_speech_features get_filterbanks)."""
    def hz2mel(hz):
        return 2595.0 * np.log10(1.0 + np.asarray(hz) / 700.0)

    def mel2hz(mel):
        return 700.0 * (10.0 ** (np.asarray(mel) / 2595.0) - 1.0)

    mel_pts = np.linspace(hz2mel(0.0), hz2mel(sr / 2.0), n_filt + 2)
    bins = np.floor((nfft + 1) * mel2hz(mel_pts) / sr).astype(int)
    fbank = np.zeros((n_filt, nfft // 2 + 1))
    for j in range(n_filt):
        for i in range(bins[j], bins[j + 1]):
            fbank[j, i] = (i - bins[j]) / (bins[j + 1] - bins[j])
        for i in range(bins[j + 1], bins[j + 2]):
            fbank[j, i] = (bins[j + 2] - i) / (bins[j + 2] - bins[j + 1])
    return fbank


_FBANK_CACHE: dict = {}


def logfbank(audio: np.ndarray, sr: int = SR, n_filt: int = N_FILT) -> np.ndarray:
    """(S,) waveform -> (t, 26) log mel filterbank energies @ 100 Hz
    (python_speech_features.logfbank default semantics: preemphasis,
    rectangular window, round-up framing with zero pad, natural log with
    eps floor)."""
    audio = np.asarray(audio, np.float64)
    # preemphasis
    emph = np.concatenate([audio[:1], audio[1:] - _PREEMPH * audio[:-1]])
    # round-up framing with zero pad
    slen = len(emph)
    if slen <= _FRAME_LEN:
        n_frames = 1
    else:
        n_frames = 1 + int(np.ceil((slen - _FRAME_LEN) / _HOP))
    pad = (n_frames - 1) * _HOP + _FRAME_LEN - slen
    emph = np.pad(emph, (0, pad))
    idx = np.arange(n_frames)[:, None] * _HOP + np.arange(_FRAME_LEN)[None, :]
    frames = emph[idx]  # rectangular window (psf default winfunc)
    pow_spec = (np.abs(np.fft.rfft(frames, _NFFT)) ** 2) / _NFFT
    key = (n_filt, _NFFT, sr)
    if key not in _FBANK_CACHE:
        _FBANK_CACHE[key] = _mel_filters(n_filt, _NFFT, sr)
    feat = pow_spec @ _FBANK_CACHE[key].T
    feat = np.where(feat == 0, np.finfo(np.float64).eps, feat)
    return np.log(feat).astype(np.float32)


def stacker(feats: np.ndarray, stack: int = STACK) -> np.ndarray:
    """(t, F) -> (ceil(t/stack), F*stack), zero-padding the remainder
    (`hubert_dataset.py:259-274` semantics — the tail frames are kept)."""
    t, F = feats.shape
    if t % stack != 0:
        feats = np.concatenate(
            [feats, np.zeros((stack - t % stack, F), feats.dtype)], axis=0
        )
    return feats.reshape(-1, stack * F)


def stacked_fbank(audio: np.ndarray, T: int, normalize: bool = True) -> np.ndarray:
    """(S,) waveform @ 16 kHz -> (T, 104) stacked features @ 25 Hz,
    zero-padded / truncated to exactly T video-aligned frames. normalize
    applies the reference's per-frame layer_norm over the 104 features."""
    f = stacker(logfbank(np.asarray(audio)))
    if normalize:
        mean = f.mean(axis=1, keepdims=True)
        var = f.var(axis=1, keepdims=True)
        f = (f - mean) / np.sqrt(var + 1e-5)
    out = np.zeros((T, STACK * N_FILT), np.float32)
    n = min(T, len(f))
    out[:n] = f[:n]
    return out


def batch_stacked_fbank(audio: np.ndarray, audio_len: np.ndarray, T: int) -> np.ndarray:
    """(B, S) padded waveforms + (B,) sample counts -> (B, T, 104)."""
    return np.stack([
        stacked_fbank(np.asarray(audio[i][: int(audio_len[i])]), T)
        for i in range(len(audio))
    ])
