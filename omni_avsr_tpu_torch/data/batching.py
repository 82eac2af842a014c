"""Frame-budget bucketing and padded collation (port of
`omni_avsr_tpu/data/batching.py`).

  - `bucket_batches`: the reference's `CustomBucketDataset`
    (`datamodule/data_module.py:82-144`): bucketize the lengths, order
    within each bucket, pack greedily until max_frames. It runs in the
    repository's C++ library (`utils/native.py`), as the JAX package does
    when the library is built; a corpus with a sample over the budget goes
    to the Python packer, which gives that sample a batch of its own, as
    the JAX package's does.
  - `collate`: pads a batch to shape buckets (video frames to a multiple of
    32, audio to 640 samples per padded frame, tokens to a multiple of 8),
    the same numpy batch dict as the JAX package's, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..ops.audio_frontend import whisper_token_len
from ..utils.native import bucket_batches_native, bucket_batches_py
from .tokenizer import IGNORE_INDEX, TokenizerBundle


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucket_batches(
    lengths: Sequence[int],
    max_frames: int,
    num_buckets: int,
    shuffle: bool = False,
    batch_size: Optional[int] = None,
    seed: int = 0,
) -> List[List[int]]:
    """Sample indices grouped into frame-budget batches."""
    if max(lengths) > max_frames:
        return bucket_batches_py(lengths, max_frames, num_buckets, shuffle, batch_size, seed)
    return bucket_batches_native(list(lengths), max_frames, num_buckets, shuffle,
                                 batch_size or 0, seed)


@dataclass
class CollateConfig:
    modality: str = "audiovisual"
    video_pad_multiple: int = 32
    token_pad_multiple: int = 8
    samples_per_frame: int = 640
    is_trainval: bool = True


def collate(samples: List[Dict], tok: TokenizerBundle, cfg: CollateConfig) -> Dict:
    """Padded batch dict of numpy arrays (keys as `models/omni.py` reads
    them). Train/val batches carry tokens and labels; test batches a bare
    BOS (Llama) or no token (Qwen) and the gold text. With audio, also
    `audio_trim_len`: the Whisper tokens of the batch's longest true
    audio (`modeling_OmniAVSR.py:536-537`), rounded up to a multiple of
    25 and at most 1500."""
    B = len(samples)
    out: Dict = {}

    if cfg.is_trainval:
        token_rows = [tok.encode(s["text"]) for s in samples]
        t_max = _round_up(max(len(r) for r in token_rows), cfg.token_pad_multiple)
        tokens = np.full((B, t_max), tok.pad_id, np.int32)
        labels = np.full((B, t_max), IGNORE_INDEX, np.int32)
        for i, r in enumerate(token_rows):
            tokens[i, : len(r)] = r
            labels[i, : len(r)] = r
        out["tokens"] = tokens
        out["labels"] = labels
    else:
        out["gold_text"] = [s["text"] for s in samples]
        out["tokens"] = np.full((B, 1 if tok.family == "llama" else 0),
                                tok.bos_id if tok.family == "llama" else 0, np.int32)

    has_video = cfg.modality in ("video", "audiovisual") and "video" in samples[0]
    has_audio = cfg.modality in ("audio", "audiovisual") and "audio" in samples[0]

    if has_video:
        v_lens = [len(s["video"]) for s in samples]
        T = _round_up(max(v_lens), cfg.video_pad_multiple)
        H, W, C = samples[0]["video"].shape[1:]
        video = np.zeros((B, T, H, W, C), np.uint8)
        for i, s in enumerate(samples):
            video[i, : len(s["video"])] = s["video"]
        out["video"] = video
        out["video_len"] = np.asarray(v_lens, np.int32)

    if has_audio:
        a_lens = [len(s["audio"]) for s in samples]
        if has_video:
            S = out["video"].shape[1] * cfg.samples_per_frame
        else:
            S = _round_up(max(a_lens), cfg.samples_per_frame * cfg.video_pad_multiple)
        audio = np.zeros((B, S), np.float32)
        for i, s in enumerate(samples):
            n = min(len(s["audio"]), S)
            audio[i, :n] = s["audio"][:n]
        out["audio"] = audio
        out["audio_len"] = np.asarray(a_lens, np.int32)
        out["audio_trim_len"] = int(min(_round_up(int(whisper_token_len(max(a_lens))), 25), 1500))
    return out
