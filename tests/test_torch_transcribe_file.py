"""`Transcriber.transcribe_file` of the port against the JAX package's, at the
tiny flagship widths (bucketed Whisper window), int8, 5 beams, the ancestor
route (`OMNI_BEAM_ATTN=kernel` on the JAX side), in f32 on both sides
(`tests/torch_parity.py::jax_in_f32`), on one numpy tree:

  - a clip of mouth frames (`preprocessed=True`) and a raw clip through the
    mouth-ROI chain with the centered detector (`preprocessed=False,
    detector="center"`), each `.npy` frames with a sibling `.wav`, and a raw
    clip with no wav (video only): the JAX method's string;
  - the ROIs the chain feeds the model agree with the JAX chain's (within
    one gray level, >= 99.9% of pixels equal);
  - a clip shorter than the smoothing window raises the JAX method's
    error; a Transcriber asked for on the card without one raises.
"""

import numpy as np
import pytest
import torch

from tests.torch_parity import jax_in_f32, transcriber_pair

T = 20  # frames; 0.8 s at 25 fps


@pytest.fixture(scope="module")
def pair():
    return transcriber_pair(32, num_beams=5)


def _clip(tmp_path, name, frames, wav=True, seed=0):
    from omni_avsr_tpu_torch.data.synthetic import _write_wav

    path = tmp_path / f"{name}.npy"
    np.save(path, frames)
    if wav:
        rng = np.random.RandomState(seed)
        _write_wav(str(tmp_path / f"{name}.wav"), (rng.randn(len(frames) * 640 + 900) * 0.1)
                   .astype(np.float32))
    return str(path)


def _raw(seed, T=T):
    return np.random.RandomState(seed).randint(0, 256, (T, 120, 160, 3), dtype=np.uint8)


CASES = {
    "preprocessed": dict(kind="mouth", wav=True, kw=dict(preprocessed=True)),
    "raw, center detector": dict(kind="raw", wav=True,
                                 kw=dict(preprocessed=False, detector="center")),
    "raw, video only": dict(kind="raw", wav=False, kw=dict(preprocessed=False, detector="center")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_transcribe_file_matches_jax(monkeypatch, pair, tmp_path, case):
    jt, pt = pair
    monkeypatch.setenv("OMNI_BEAM_ATTN", "kernel")
    jax_in_f32(monkeypatch)
    c = CASES[case]
    frames = (np.random.RandomState(3).randint(0, 256, (T, 96, 96, 3), dtype=np.uint8)
              if c["kind"] == "mouth" else _raw(4))
    path = _clip(tmp_path, "clip", frames, wav=c["wav"])
    want = jt.transcribe_file(path, **c["kw"])
    got = pt.transcribe_file(path, **c["kw"])
    assert isinstance(got, str) and got == want
    stages = {"decode_s"} | ({"detector_s", "roi_s"} if c["kind"] == "raw" else set())
    assert set(pt.last_file_seconds) == stages


def test_chain_feeds_the_jax_rois():
    from omni_avsr_tpu.preprocess.detector import CenterFaceLandmarker as JaxCenter
    from omni_avsr_tpu.preprocess.mean_face import load_mean_face as jax_mean_face
    from omni_avsr_tpu.preprocess.video_process import extract_mouth_rois as jax_rois
    from omni_avsr_tpu_torch.preprocess.detector import build_detector
    from omni_avsr_tpu_torch.preprocess.mean_face import load_mean_face
    from omni_avsr_tpu_torch.preprocess.video_process import extract_mouth_rois

    frames = _raw(4)
    ours = extract_mouth_rois(frames, build_detector("center", device="cpu")(frames),
                              load_mean_face(), device="cpu")
    theirs = jax_rois(frames, JaxCenter()(frames), jax_mean_face())
    diff = np.abs(ours.astype(np.int32) - theirs.astype(np.int32))
    assert ours.shape == (T, 96, 96) and diff.max() <= 1 and (diff == 0).mean() >= 0.999


def test_short_clip_raises_the_jax_error(monkeypatch, pair, tmp_path):
    jt, pt = pair
    jax_in_f32(monkeypatch)
    path = _clip(tmp_path, "short", _raw(5, T=8))
    for t in (jt, pt):
        with pytest.raises(ValueError, match="shorter than the 12-frame smoothing window"):
            t.transcribe_file(path, detector="center")


def test_card_asked_for_without_one_raises(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from omni_avsr_tpu_torch.serve import Transcriber

    _, pt = pair
    with pytest.raises((RuntimeError, AssertionError)):
        Transcriber(pt.model, pt.params)  # device "cuda" by default
