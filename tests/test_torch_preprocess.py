"""The port's mouth-ROI chain (`omni_avsr_tpu_torch/preprocess/`) against the
JAX package's, whose image steps are OpenCV:

  - grayscale: bit-equal to `cv2.cvtColor(RGB2GRAY)` on all 2^24 colours;
  - warp: bit-equal to `cv2.warpAffine` through the JAX `warp_frame`, on
    rotations, scales and shifts, coordinates that leave the frame, and
    three channels;
  - similarity: the inlier sets of `cv2.estimateAffinePartial2D(LMEDS)`
    exactly, on similarity images of the mean face, with 1 px noise and with
    one gross outlier. The port's matrix is the least-squares optimum over
    those inliers; OpenCV's refinement stops short of it, so the JAX matrix
    differs by up to ~2e-7 in the linear part and ~2e-5 px in the
    translation (500 draws of each kind), and never fits the inliers better;
  - `extract_mouth_rois` against the JAX one: max one gray level, >= 99.9%
    of pixels equal (what the similarity's difference leaves), plus the None
    cases, interpolation, smoothing and `cut_patch`'s OverflowError;
  - the mean face bit for bit.
"""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from omni_avsr_tpu.preprocess import video_process as J  # noqa: E402
from omni_avsr_tpu.preprocess.mean_face import canonical_mean_face as jax_mean_face  # noqa: E402
from omni_avsr_tpu.preprocess.mean_face import load_mean_face as jax_load_mean_face  # noqa: E402
from omni_avsr_tpu_torch.preprocess import video_process as P  # noqa: E402
from omni_avsr_tpu_torch.preprocess.mean_face import (  # noqa: E402
    canonical_mean_face,
    load_mean_face,
)
from tests.test_preprocess_parity import _synthetic_clip  # noqa: E402

STABLE = list(P.STABLE_POINTS)


def _similarity(ang, scale, tx, ty):
    c, s = scale * np.cos(ang), scale * np.sin(ang)
    return np.array([[c, -s, tx], [s, c, ty]])


def test_gray_bit_equal_on_every_colour():
    v = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)
    ours = P.rgb_to_gray(torch.as_tensor(rgb)).numpy()
    np.testing.assert_array_equal(ours, cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))


WARPS = {
    "rotations": [_similarity(a, 1.0, 0.0, 0.0) for a in (-0.7, -0.2, 0.05, 0.4, 1.3)],
    "scales": [_similarity(0.1, s, -20.0, 15.0) for s in (0.3, 0.77, 1.0, 1.9, 3.3)],
    "shifts": [_similarity(0.0, 1.0, tx, ty) for tx, ty in
               ((0.5, 0.25), (-13.37, 7.01), (40.2, -33.9), (0.03125, 0.0), (-0.49, 101.6))],
    # most of the canvas maps outside the frame, from every side
    "leaving the frame": [_similarity(0.3, 0.5, 200.0, 150.0),
                          _similarity(-0.4, 2.5, -300.0, 80.0),
                          _similarity(2.8, 1.1, 400.0, 420.0),
                          _similarity(0.0, 1.0, -250.0, -240.0)],
}


@pytest.mark.parametrize("kind", sorted(WARPS))
@pytest.mark.parametrize("channels", [1, 3])
def test_warp_bit_equal_to_cv2(kind, channels):
    rng = np.random.RandomState(len(kind) + channels)
    ms = WARPS[kind]
    shape = (len(ms), 150, 210) + ((3,) if channels == 3 else ())
    frames = rng.randint(0, 256, shape).astype(np.uint8)
    frames[::2] = cv2.GaussianBlur(frames[0], (7, 7), 2.0)  # smooth frames too
    ours = P.warp_frames(torch.as_tensor(frames), ms, 256, chunk=3).numpy()
    theirs = np.stack([J.warp_frame(f, m) for f, m in zip(frames, ms)])
    assert ours.dtype == np.uint8 and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)
    one = P.warp_frame(frames[1], ms[1], device="cpu")
    np.testing.assert_array_equal(one, theirs[1])


def _stable_points(kind: str, rng):
    mf = canonical_mean_face(256)
    m = _similarity(rng.uniform(-0.5, 0.5), rng.uniform(0.4, 2.5), *rng.uniform(-80, 80, 2))
    src = P.apply_transform_to_landmarks(mf, m)[STABLE]
    if kind != "exact":
        src = src + rng.randn(8, 2)
    if kind == "outlier":
        src[rng.randint(8)] += rng.uniform(20, 60, 2) * rng.choice([-1, 1], 2)
    return src, mf[STABLE]


@pytest.mark.parametrize("kind", ["exact", "noise", "outlier"])
def test_similarity_matches_opencv(kind):
    rng = np.random.RandomState({"exact": 0, "noise": 1, "outlier": 2}[kind])
    for _ in range(60):
        src, ref = _stable_points(kind, rng)
        _, cv_inliers = cv2.estimateAffinePartial2D(src, ref, method=cv2.LMEDS)
        inliers = P.similarity_inliers(src, ref)
        np.testing.assert_array_equal(inliers, cv_inliers.ravel().astype(bool))
        if kind == "outlier":
            assert inliers.sum() == 7
        ours, theirs = P.estimate_similarity(src, ref), J.estimate_similarity(src, ref)
        assert np.abs(ours[:, :2] - theirs[:, :2]).max() <= 1e-6
        assert np.abs(ours[:, 2] - theirs[:, 2]).max() <= 1e-4
        assert ours[0, 0] == ours[1, 1] and ours[0, 1] == -ours[1, 0]

        # the port's matrix is the optimum over the inliers: OpenCV's never fits better
        s, d = src.astype(np.float32)[inliers], ref.astype(np.float32)[inliers]

        def sse(m):
            return float(((P.apply_transform_to_landmarks(s, m) - d) ** 2).sum())

        assert sse(ours) <= sse(theirs) * (1 + 1e-12) + 1e-18


def test_similarity_sampler_and_degenerate_points():
    # OpenCV's generator from 2^64 - 1 draws these 13 pairs of 8 points
    assert P.opencv_pairs(8) == ((5, 4), (4, 5), (7, 0), (5, 0), (5, 6), (1, 2), (2, 1), (2, 7),
                                 (6, 0), (6, 0), (0, 3), (3, 0), (1, 0))
    ref = canonical_mean_face(256)[STABLE]
    for pts in (np.zeros((8, 2)), np.tile([[3.0, 4.0]], (8, 1))):
        np.testing.assert_array_equal(P.estimate_similarity(pts, ref),
                                      J.estimate_similarity(pts, ref))
        np.testing.assert_array_equal(P.estimate_similarity(pts, ref), np.eye(2, 3))


def _roi_agreement(ours, theirs):
    assert ours is not None and theirs is not None and ours.shape == theirs.shape
    diff = np.abs(ours.astype(np.int32) - theirs.astype(np.int32))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999
    return diff


@pytest.mark.parametrize("gaps", [(3, 4, 9), (0, 1, 27, 28, 29)])
def test_extract_mouth_rois_matches_jax(gaps):
    """Interior gaps interpolate; leading and trailing ones copy the edge."""
    frames, lms = _synthetic_clip(T=30, gaps=gaps)
    mf = canonical_mean_face(256)
    ours = P.extract_mouth_rois(frames, lms, mf, device="cpu")
    theirs = J.extract_mouth_rois(frames, lms, mf)
    assert ours.shape == (30, 96, 96) and ours.dtype == np.uint8
    _roi_agreement(ours, theirs)


def test_extract_mouth_rois_colour_matches_jax():
    frames, lms = _synthetic_clip(T=14)
    frames = frames.copy()
    frames[..., 0] //= 2  # distinct channels
    mf = canonical_mean_face(256)
    ours = P.extract_mouth_rois(frames, lms, mf, convert_gray=False, device="cpu")
    assert ours.shape == (14, 96, 96, 3)
    _roi_agreement(ours, J.extract_mouth_rois(frames, lms, mf, convert_gray=False))


@pytest.mark.parametrize("case", ["short clip", "no detection"])
def test_extract_mouth_rois_none(case):
    frames, lms = _synthetic_clip(T=8 if case == "short clip" else 16, gaps=())
    if case == "no detection":
        lms = [None] * len(frames)
    mf = canonical_mean_face(256)
    assert J.extract_mouth_rois(frames, lms, mf) is None
    assert P.extract_mouth_rois(frames, lms, mf, device="cpu") is None


def test_interpolation_and_smoothing_match_jax():
    _, lms = _synthetic_clip(T=20, gaps=(0, 5, 6, 7, 19))
    ours, theirs = P.interpolate_landmarks(lms), J.interpolate_landmarks(lms)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours[0], ours[1])  # leading gap copies
    np.testing.assert_array_equal(ours[19], ours[18])  # trailing gap copies
    np.testing.assert_allclose(ours[6], (ours[4] * 2 + ours[8] * 2) / 4)  # midway
    stacked = np.stack(ours)
    for i in (0, 3, 10, 19):
        sm = P.smoothed_frame_landmarks(stacked, i)
        np.testing.assert_array_equal(sm, J.smoothed_frame_landmarks(stacked, i))
        np.testing.assert_allclose(sm.mean(axis=0), stacked[i].mean(axis=0))  # re-centred
    assert P.interpolate_landmarks([None, None]) is None


@pytest.mark.parametrize("axis", ["height", "width"])
def test_cut_patch_overflow(axis):
    img = np.zeros((256, 256), np.uint8)
    shift = np.array([0.0, 60.0]) if axis == "height" else np.array([60.0, 0.0])
    lms = np.full((20, 2), 128.0) + shift
    for cut in (P.cut_patch, J.cut_patch):
        with pytest.raises(OverflowError, match=f"bias in {axis}"):
            cut(img, lms, 48, 48)
    ok = np.full((20, 2), 128.0) + shift / 20
    np.testing.assert_array_equal(P.cut_patch(img, ok, 48, 48), J.cut_patch(img, ok, 48, 48))


def test_mean_face_bit_equal(tmp_path):
    for size in (256, 96):
        np.testing.assert_array_equal(canonical_mean_face(size), jax_mean_face(size))
    path = tmp_path / "mean_face.npy"
    np.save(path, np.random.RandomState(0).rand(68, 2).astype(np.float32))
    np.testing.assert_array_equal(load_mean_face(str(path)), jax_load_mean_face(str(path)))
    np.testing.assert_array_equal(load_mean_face(None), jax_load_mean_face(None))


def test_card_asked_for_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    frames, lms = _synthetic_clip(T=14)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.extract_mouth_rois(frames, lms, canonical_mean_face(256))
