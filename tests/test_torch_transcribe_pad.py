"""`Transcriber.transcribe` of the port against the JAX package's at a
`video_pad_multiple` of 24 (the default 32: tests/test_torch_transcribe.py):
audio only, video only, audiovisual, and audiovisual with
`modality="audio"`, at the tiny flagship widths, int8, 5 beams, in f32 on
both sides."""

import pytest

from tests.test_torch_transcribe import CASES, IDS
from tests.torch_parity import check_transcribe, transcriber_pair


@pytest.fixture(scope="module")
def pair():
    jt, pt = transcriber_pair(24, num_beams=5)
    assert jt.video_pad_multiple == pt.video_pad_multiple == 24
    return jt, pt


@pytest.mark.parametrize("streams,modality", CASES, ids=IDS)
def test_transcribe_matches_jax(monkeypatch, pair, streams, modality):
    check_transcribe(monkeypatch, *pair, streams, modality)
