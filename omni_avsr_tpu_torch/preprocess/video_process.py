"""Mouth-ROI extraction: landmark interpolation, temporal smoothing,
similarity warp to the mean face, 96x96 mouth crop (port of
`omni_avsr_tpu/preprocess/video_process.py`, reference
`preprocessing_inference_example/video_process.py`).

The JAX package runs the three image steps through OpenCV; the port does
the same arithmetic itself, so it needs no OpenCV:

  - grayscale: OpenCV's 8-bit `COLOR_RGB2GRAY`, `(9798 R + 19235 G + 3735 B
    + 2^14) >> 15` in integers (the 15-bit coefficients of OpenCV's current
    releases; the 14-bit `4899, 9617, 1868` of older ones differ by one
    level on 0.8% of colours), on the device over the whole clip at once.
    The tests hold it equal to `cv2.cvtColor` on all 2^24 colours;
  - similarity (`cv2.estimateAffinePartial2D(..., LMEDS)`), on the host in
    float64 over the 8 stable points of each frame. The points are rounded
    to float32 first, as OpenCV stores them. The sampler is OpenCV's own:
    its random generator restarts from the state 2^64 - 1 on every call, so
    the 13 point pairs it draws (`RANSACUpdateNumIters` at confidence 0.99
    and outlier ratio 0.45) are a fixed list for a given point count, which
    `opencv_pairs` reproduces. Per pair: the two-point similarity, the
    float32 squared errors and their median; the pair of least median wins.
    Inliers are the points whose squared error is within sigma^2, with
    sigma = max(2.5 * 1.4826 * (1 + 5 / (n - 2)) * sqrt(min median), 0.001).
    The estimate is then the least-squares similarity over the inliers, the
    optimum OpenCV's Levenberg-Marquardt refinement moves toward. The inlier
    sets are OpenCV's exactly, bar a squared error that lands on the
    threshold within a float32 rounding (OpenCV may fuse the multiply-add
    there). OpenCV stops its refinement after at most 10 steps, a few 1e-6
    px short of the optimum, so the matrices differ from its own at that
    level. No median (every pair degenerate) or fewer than 2 inliers gives
    the identity, as `cv2` returning None does in the JAX package (`:76-77`);
  - warp (`cv2.warpAffine`, `INTER_LINEAR`, `BORDER_CONSTANT` 0), on the
    device, batched over the clip: the matrix inverted in float64 and
    rounded to float32; per output row the float32 offsets `y * M1 + M2`,
    per pixel the source coordinate `fma(M0, x, offset)`; the four taps
    (zero outside the frame) blended in float32 with two fused multiply-adds
    along x and one along y, rounded half to even and saturated to uint8.
    This is the arithmetic of OpenCV's 8-bit bilinear warp since 4.11 (the
    fixed-point path of earlier releases, with its 1/32-pixel table, is
    gone); the tests hold it bit-equal to `cv2.warpAffine`.

Frames and ROIs stay uint8. Clips shorter than the smoothing window, or
with no detection, give None (`:80-84`).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# the similarity's anchor points: nose bridge/tip, eye corners, mouth
# corners (`video_process.py:155`)
STABLE_POINTS: Tuple[int, ...] = (28, 33, 36, 39, 42, 45, 48, 54)
MOUTH_START, MOUTH_STOP = 48, 68
GRAY_COEFFS = (9798, 19235, 3735)  # R, G, B in units of 2^-15


def resolve_device(device) -> torch.device:
    """`device` as a torch device; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device here; pass device='cpu' to run "
                           f"the preprocessing on the CPU")
    return dev


def interpolate_landmarks(landmarks: List[Optional[np.ndarray]]) -> Optional[List[np.ndarray]]:
    """Fill None frames by linear interpolation between detected neighbours;
    leading/trailing gaps copy the nearest detection (`:120-145`).
    Returns None when no frame has a detection."""
    idx = [i for i, lm in enumerate(landmarks) if lm is not None]
    if not idx:
        return None
    out: List[np.ndarray] = [None] * len(landmarks)  # type: ignore
    for i, lm in enumerate(landmarks):
        if lm is not None:
            out[i] = np.asarray(lm, np.float64)
    for a, b in zip(idx[:-1], idx[1:]):
        for i in range(a + 1, b):
            w = (i - a) / float(b - a)
            out[i] = (1 - w) * out[a] + w * out[b]
    for i in range(0, idx[0]):
        out[i] = out[idx[0]]
    for i in range(idx[-1] + 1, len(landmarks)):
        out[i] = out[idx[-1]]
    return out


def smoothed_frame_landmarks(landmarks: np.ndarray, frame_idx: int,
                             window_margin: int = 12) -> np.ndarray:
    """Symmetric shrinking-window mean around `frame_idx`, re-centred on the
    frame's own landmark centroid (`:93-107`)."""
    T = len(landmarks)
    m = min(window_margin // 2, frame_idx, T - 1 - frame_idx)
    sm = landmarks[frame_idx - m: frame_idx + m + 1].mean(axis=0)
    return sm + landmarks[frame_idx].mean(axis=0) - sm.mean(axis=0)


# ---------------------------------------------------------------- similarity


@lru_cache(maxsize=None)
def opencv_pairs(count: int, iters: int = 13) -> Tuple[Tuple[int, int], ...]:
    """The point pairs OpenCV's LMedS draws for `count` points: its
    multiply-with-carry generator (`cv::RNG`, coefficient 4164903690) from
    the state 2^64 - 1, `uniform(0, count)` redrawn until the pair's two
    indices differ."""
    state, mask = (1 << 64) - 1, (1 << 64) - 1
    pairs = []
    for _ in range(iters):
        pick: List[int] = []
        while len(pick) < 2:
            state = ((state & 0xFFFFFFFF) * 4164903690 + (state >> 32)) & mask
            i = (state & 0xFFFFFFFF) % count
            if i not in pick:
                pick.append(i)
        pairs.append((pick[0], pick[1]))
    return tuple(pairs)


def _two_point_similarity(f: np.ndarray, t: np.ndarray) -> np.ndarray:
    """OpenCV's closed-form similarity through two point pairs (float64)."""
    (x1, y1), (x2, y2) = f
    (X1, Y1), (X2, Y2) = t
    d = 1.0 / ((x1 - x2) * (x1 - x2) + (y1 - y2) * (y1 - y2))
    s0 = d * ((X1 - X2) * (x1 - x2) + (Y1 - Y2) * (y1 - y2))
    s1 = d * ((Y1 - Y2) * (x1 - x2) - (X1 - X2) * (y1 - y2))
    s2 = d * ((Y1 - Y2) * (x1 * y2 - x2 * y1) - (X1 * y2 - X2 * y1) * (y1 - y2)
              - (X1 * x2 - X2 * x1) * (x1 - x2))
    s3 = d * (-(X1 - X2) * (x1 * y2 - x2 * y1) - (Y1 * x2 - Y2 * x1) * (x1 - x2)
              - (Y1 * y2 - Y2 * y1) * (y1 - y2))
    return np.array([[s0, -s1, s2], [s1, s0, s3]])


def _squared_errors(m: np.ndarray, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """OpenCV's float32 reprojection errors of float32 points."""
    f = m.astype(np.float32)
    a = f[0, 0] * src[:, 0] + f[0, 1] * src[:, 1] + f[0, 2] - dst[:, 0]
    b = f[1, 0] * src[:, 0] + f[1, 1] * src[:, 1] + f[1, 2] - dst[:, 1]
    return a * a + b * b


def _least_squares_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """argmin over (a, b, tx, ty) of sum |[[a, -b], [b, a]] p + t - q|^2."""
    s, d = src.astype(np.float64), dst.astype(np.float64)
    n = len(s)
    A = np.zeros((2 * n, 4))
    A[0::2] = np.stack([s[:, 0], -s[:, 1], np.ones(n), np.zeros(n)], 1)
    A[1::2] = np.stack([s[:, 1], s[:, 0], np.zeros(n), np.ones(n)], 1)
    a, b, tx, ty = np.linalg.lstsq(A, d.reshape(-1), rcond=None)[0]
    return np.array([[a, -b, tx], [b, a, ty]])


def similarity_inliers(src: np.ndarray, dst: np.ndarray) -> Optional[np.ndarray]:
    """OpenCV's LMedS inlier mask of the similarity src -> dst, or None
    where it finds no model (see the module docstring)."""
    src = np.asarray(src, np.float32)
    dst = np.asarray(dst, np.float32)
    n = len(src)
    if n < 2:
        return None
    if n == 2:
        return np.ones(2, bool)
    best, min_median = None, np.inf
    with np.errstate(all="ignore"):
        for i, j in opencv_pairs(n):
            m = _two_point_similarity(src[[i, j]].astype(np.float64),
                                      dst[[i, j]].astype(np.float64))
            median = np.partition(_squared_errors(m, src, dst), n // 2)[n // 2]
            if median < min_median:  # False for NaN, as in OpenCV
                min_median, best = median, m
        if best is None:
            return None
        sigma = max(2.5 * 1.4826 * (1 + 5.0 / (n - 2)) * np.sqrt(min_median), 0.001)
        inliers = _squared_errors(best, src, dst) <= np.float32(sigma * sigma)
    return inliers if inliers.sum() >= 2 else None


def estimate_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The 2x3 similarity src -> dst of `cv2.estimateAffinePartial2D(src,
    dst, method=cv2.LMEDS)` (`:188-193`); the identity where it finds none."""
    inliers = similarity_inliers(src, dst)
    if inliers is None:
        return np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    src32 = np.asarray(src, np.float32)[inliers]
    dst32 = np.asarray(dst, np.float32)[inliers]
    return _least_squares_similarity(src32, dst32)


def apply_transform_to_landmarks(lms: np.ndarray, m: np.ndarray) -> np.ndarray:
    return lms @ m[:, :2].T + m[:, 2]


# ------------------------------------------------------------ device steps


def rgb_to_gray(frames: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 RGB -> (...) uint8: OpenCV's 8-bit `COLOR_RGB2GRAY`."""
    x = frames.to(torch.int32)
    r, g, b = GRAY_COEFFS
    y = x[..., 0] * r + x[..., 1] * g + x[..., 2] * b
    return ((y + (1 << 14)) >> 15).to(torch.uint8)


def invert_affine(m: np.ndarray) -> np.ndarray:
    """OpenCV's inverse of a 2x3 affine map, in float64 (a singular matrix
    gives the zero map, as OpenCV's does)."""
    M = np.asarray(m, np.float64).reshape(6).copy()
    D = M[0] * M[4] - M[1] * M[3]
    D = 1.0 / D if D != 0 else 0.0
    a11, a22 = M[4] * D, M[0] * D
    M[0], M[1], M[3], M[4] = a11, -M[1] * D, -M[3] * D, a22
    M[2], M[5] = -M[0] * M[2] - M[1] * M[5], -M[3] * M[2] - M[4] * M[5]
    return M


def warp_frames(frames: torch.Tensor, ms: Sequence[np.ndarray], size: int = 256,
                chunk: int = 64) -> torch.Tensor:
    """`cv2.warpAffine(frame, m, (size, size), INTER_LINEAR, BORDER_CONSTANT
    0)` of every frame: (T, H, W[, C]) uint8 and T (2, 3) matrices -> (T,
    size, size[, C]) uint8 on the frames' device, `chunk` frames at a time
    (the arithmetic is in the module docstring)."""
    inv = np.stack([invert_affine(m) for m in ms]).astype(np.float32)  # (T, 6)
    return torch.cat([_warp_chunk(frames[i:i + chunk], inv[i:i + chunk], size)
                      for i in range(0, len(frames), chunk)])


def _warp_chunk(frames: torch.Tensor, inv: np.ndarray, size: int) -> torch.Tensor:
    """float64 holds each fused multiply-add exactly before its one rounding
    to float32."""
    dev, f32, f64 = frames.device, torch.float32, torch.float64
    T, H, W = frames.shape[:3]
    inv = torch.as_tensor(inv, device=dev)
    grid = torch.arange(size, device=dev, dtype=f32)
    # per row: float32 products and sums, as OpenCV forms them
    off_x = grid[None, :] * inv[:, 1:2] + inv[:, 2:3]  # (T, size) over y
    off_y = grid[None, :] * inv[:, 4:5] + inv[:, 5:6]
    # per pixel: one fused multiply-add
    sx = (grid.to(f64)[None, None, :] * inv[:, 0, None, None].to(f64)
          + off_x[:, :, None].to(f64)).to(f32)  # (T, y, x)
    sy = (grid.to(f64)[None, None, :] * inv[:, 3, None, None].to(f64)
          + off_y[:, :, None].to(f64)).to(f32)
    ix, iy = torch.floor(sx), torch.floor(sy)
    ax, ay = (sx - ix).to(f64)[..., None], (sy - iy).to(f64)[..., None]
    ix, iy = ix.to(torch.int64), iy.to(torch.int64)
    src = frames.reshape(T, H * W, -1)
    tidx = torch.arange(T, device=dev)[:, None, None]

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        flat = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
        return src[tidx, flat].to(f64) * ok[..., None]  # (T, size, size, C)

    p00, p01 = tap(iy, ix), tap(iy, ix + 1)
    p10, p11 = tap(iy + 1, ix), tap(iy + 1, ix + 1)
    f0 = (ax * (p01 - p00) + p00).to(f32)
    f1 = (ax * (p11 - p10) + p10).to(f32)
    v = (ay * (f1 - f0).to(f64) + f0.to(f64)).to(f32)
    out = torch.round(v).clamp(0, 255).to(torch.uint8)
    return out.reshape((T, size, size) + tuple(frames.shape[3:]))


def warp_frame(frame: np.ndarray, m: np.ndarray, size: int = 256, device="cuda") -> np.ndarray:
    """One frame through `warp_frames` (`:205-212`)."""
    t = torch.as_tensor(np.ascontiguousarray(frame), device=resolve_device(device))
    return warp_frames(t[None], [m], size)[0].cpu().numpy()


def cut_patch(img: np.ndarray, landmarks: np.ndarray, half_height: int, half_width: int,
              threshold: int = 5) -> np.ndarray:
    """Cut a patch centred on the landmark centroid with the reference's
    overflow check and round+clip bbox (`:38-52`)."""
    center_x, center_y = np.mean(landmarks, axis=0)
    if abs(center_y - img.shape[0] / 2) > half_height + threshold:
        raise OverflowError("too much bias in height")
    if abs(center_x - img.shape[1] / 2) > half_width + threshold:
        raise OverflowError("too much bias in width")
    y_min = int(round(np.clip(center_y - half_height, 0, img.shape[0])))
    y_max = int(round(np.clip(center_y + half_height, 0, img.shape[0])))
    x_min = int(round(np.clip(center_x - half_width, 0, img.shape[1])))
    x_max = int(round(np.clip(center_x + half_width, 0, img.shape[1])))
    return np.copy(img[y_min:y_max, x_min:x_max])


def extract_mouth_rois(
    frames: np.ndarray,  # (T, H, W, 3) uint8 RGB
    landmarks: List[Optional[np.ndarray]],  # per-frame (68, 2) or None
    mean_face: np.ndarray,  # (68, 2)
    crop_size: int = 96,
    canvas: int = 256,
    window_margin: int = 12,
    convert_gray: bool = True,
    device="cuda",
) -> Optional[np.ndarray]:
    """Full deterministic tail -> (T, crop, crop) uint8 grayscale mouth ROIs
    (or (T, crop, crop, 3) with convert_gray=False): the similarities on the
    host, grayscale and warp of the whole clip on `device`, the crops on the
    host. None when no frame has a detection or the clip is shorter than
    the smoothing window, as `VideoProcess.__call__` (`:76-88`)."""
    dev = resolve_device(device)
    lms_list = interpolate_landmarks(landmarks)
    if lms_list is None or len(lms_list) < window_margin:
        return None
    lms = np.stack(lms_list)  # (T, 68, 2)
    stable_idx = list(STABLE_POINTS)
    # reference_size == target_size == (canvas, canvas): no offset in
    # get_stable_reference (`:180-186`)
    stable_ref = mean_face[stable_idx].astype(np.float64)
    smoothed = [smoothed_frame_landmarks(lms, i, window_margin) for i in range(len(frames))]
    ms = [estimate_similarity(sm[stable_idx], stable_ref) for sm in smoothed]
    x = torch.as_tensor(np.ascontiguousarray(frames), device=dev)
    if convert_gray:
        x = rgb_to_gray(x)
    warped = warp_frames(x, ms, canvas).cpu().numpy()
    half = crop_size // 2
    return np.array([
        cut_patch(w, apply_transform_to_landmarks(sm, m)[MOUTH_START:MOUTH_STOP], half, half)
        for w, sm, m in zip(warped, smoothed, ms)])
