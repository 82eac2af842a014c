"""The single-request serving API of the port against the JAX package's, at
the tiny flagship widths (bucketed Whisper window), int8, 5 beams, the
ancestor route (`OMNI_BEAM_ATTN=kernel` on the JAX side), in f32 on both
sides (`tests/torch_parity.py::jax_in_f32`):

  - `Transcriber.transcribe` gives the JAX `transcribe`'s string for
    audio only, video only, audiovisual, and audiovisual with
    `modality="audio"` (the audio padded to the padded video's length, as
    the JAX method pads it, unlike `transcribe_many`), at the default
    `video_pad_multiple` of 32 (24: tests/test_torch_transcribe_pad.py);
  - `bucket_class` equals the JAX one over a ladder of lengths.
"""

import numpy as np
import pytest

from omni_avsr_tpu_torch.serve import Transcriber, pad_batch
from tests.torch_parity import check_transcribe, transcriber_pair

CASES = [("audio", None), ("video", None), ("audiovisual", None), ("audiovisual", "audio")]
IDS = ["audio", "video", "audiovisual", "audiovisual-as-audio"]


@pytest.fixture(scope="module")
def pair():
    return transcriber_pair(32, num_beams=5)


@pytest.mark.parametrize("streams,modality", CASES, ids=IDS)
def test_transcribe_matches_jax(monkeypatch, pair, streams, modality):
    check_transcribe(monkeypatch, *pair, streams, modality)


def test_transcribe_pads_audio_to_the_video():
    """With both streams, `transcribe`'s padding is the audiovisual one
    even for `modality="audio"`: another window than `transcribe_many`'s
    audio-only padding of the same audio."""
    audio, video = np.ones(37 * 640, np.float32), np.zeros((20, 96, 96, 3), np.uint8)
    both, trim_both = pad_batch([{"audio": audio, "video": video}], "audiovisual")
    alone, trim_alone = pad_batch([{"audio": audio}], "audio")
    assert both["audio"].shape == (1, 32 * 640) and both["audio_len"][0] == 32 * 640
    assert alone["audio"].shape == (1, 64 * 640) and trim_both < trim_alone


def test_bucket_class_matches_jax():
    from omni_avsr_tpu.serve import Transcriber as JaxTranscriber

    for multiple in (32, 24, 7):
        jt = JaxTranscriber.__new__(JaxTranscriber)
        jt.video_pad_multiple = multiple
        pt = Transcriber.__new__(Transcriber)
        pt.video_pad_multiple = multiple
        for n in list(range(1, 130)) + [300, 481, 1000]:
            item = {"audio": np.zeros(n * 640 - 13, np.float32), "video": np.zeros((n, 1, 1, 1))}
            for modality in ("audio", "video", "audiovisual"):
                assert pt.bucket_class(item, modality) == jt.bucket_class(item, modality)
