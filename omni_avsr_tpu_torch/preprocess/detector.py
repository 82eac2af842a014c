"""Pluggable face-detection / landmark backends for preprocessing (port of
`omni_avsr_tpu/preprocess/detector.py`).

The reference uses RetinaFace (resnet50) + FAN 68-landmark models through
the ibug packages (`preprocessing_inference_example/detector.py:15-38`),
picking the largest face per frame. The backends:

  - `TorchLandmarksDetector`: the port's RetinaFace-ResNet50 + FAN
    (preprocess/retinaface.py, preprocess/fan.py) on a device, fed by
    converted trees or by the public torch weight files through
    convert/detector_torch.py. The counterpart of the JAX package's
    `JaxLandmarksDetector`, with the same results per frame; it runs the
    clip's frames in batches.
  - `IbugLandmarksDetector`: the original ibug-package path, used when
    those packages (+ weights) are installed; imported lazily.
  - `CenterFaceLandmarker`: weights-free fallback for corpora where the
    speaker is centered and frame-filling (LRS2/LRS3-style crops, synthetic
    data): the canonical mean face projected into a centered box. This is
    the JAX package's own behaviour when no weights are given, not a
    device fallback.
"""

from __future__ import annotations

from typing import Any, List, Optional, Protocol

import numpy as np
import torch

from .mean_face import canonical_mean_face
from .video_process import resolve_device


class LandmarksDetector(Protocol):
    def __call__(self, frames: np.ndarray) -> List[Optional[np.ndarray]]:
        """(T, H, W, 3) uint8 -> per-frame (68, 2) landmarks or None."""
        ...


def largest_face_index(faces: np.ndarray) -> int:
    """The reference's largest-face pick: width+height SUM, not area, first
    wins on ties (`preprocessing_inference_example/detector.py:33-37`)."""
    sizes = (faces[:, 2] - faces[:, 0]) + (faces[:, 3] - faces[:, 1])
    return int(np.argmax(sizes))


class IbugLandmarksDetector:
    """RetinaFace + FAN through the ibug packages, largest-face pick per
    frame (reference behaviour). FAN runs only on the selected face, which
    gives the same landmarks (per-face FAN results are independent)."""

    def __init__(self, device: str = "cuda"):
        from ibug.face_alignment import FANPredictor
        from ibug.face_detection import RetinaFacePredictor

        self.face_detector = RetinaFacePredictor(
            device=device, threshold=0.8, model=RetinaFacePredictor.get_model("resnet50"))
        self.landmark_detector = FANPredictor(device=device, model=None)

    def __call__(self, frames: np.ndarray) -> List[Optional[np.ndarray]]:
        out: List[Optional[np.ndarray]] = []
        for frame in frames:
            faces = self.face_detector(frame, rgb=False)
            if len(faces) == 0:
                out.append(None)
                continue
            face = faces[largest_face_index(faces)]
            landmarks, _ = self.landmark_detector(frame, face[None], rgb=True)
            out.append(np.asarray(landmarks[0], np.float64))
        return out


def _load_tree(p: Any, convert, **kw) -> Any:
    """A converted tree as given, or the public `.pth` at path `p` converted."""
    if not isinstance(p, str):
        return p
    sd = torch.load(p, map_location="cpu")
    sd = sd.get("state_dict", sd)
    return convert({k.removeprefix("module."): v for k, v in sd.items()}, **kw)


class TorchLandmarksDetector:
    """RetinaFace + FAN on `device`, largest-face pick per frame: the
    reference semantics (`preprocessing_inference_example/detector.py:24-38`)
    without the ibug packages.

    retinaface_params / fan_params: converted trees (convert/detector_torch.py,
    numpy or torch leaves), or paths to the public torch checkpoints
    (`Resnet50_Final.pth`, a 1adrianb-layout FAN .pth), loaded and converted
    here. Frames arrive as the JAX detector takes them: RetinaFace reads
    them as BGR, FAN as RGB (channels reversed), as the reference does.
    `batch` frames (or face crops) go through a network at a time."""

    def __init__(self, retinaface_params, fan_params, threshold: float = 0.8,
                 fan_modules: int = 2, device="cuda", batch: int = 32):
        from ..convert.detector_torch import convert_fan, convert_retinaface
        from .retinaface import conv_layout

        self.device = resolve_device(device)
        rf = _load_tree(retinaface_params, convert_retinaface)
        fan = _load_tree(fan_params, convert_fan, num_modules=fan_modules)
        self.rf = conv_layout(rf, self.device)
        self.fan = conv_layout(fan, self.device)
        self.threshold = threshold
        self.batch = batch

    def faces(self, frames: torch.Tensor) -> List[np.ndarray]:
        """Per frame the score-sorted (N, 5) RetinaFace boxes."""
        from .retinaface import detect_faces

        return detect_faces(self.rf, frames, threshold=self.threshold, batch=self.batch)

    def __call__(self, frames: np.ndarray) -> List[Optional[np.ndarray]]:
        from .fan import fan_landmarks

        x = torch.as_tensor(np.ascontiguousarray(frames), device=self.device)
        faces = self.faces(x)
        out: List[Optional[np.ndarray]] = [None] * len(faces)
        picked, boxes = [], []
        for i, f in enumerate(faces):
            if len(f) == 0:
                continue
            face = f[largest_face_index(f)]
            if (not np.all(np.isfinite(face[:4]))) or face[2] <= face[0] or face[3] <= face[1]:
                # a degenerate box (detect_faces filters these already) is no
                # detection; interpolation covers the gap (`video_process.py:120-145`)
                continue
            picked.append(i)
            boxes.append(face[:4])
        if picked:
            rgb = x[torch.as_tensor(picked, device=self.device)].flip(-1)  # FAN reads RGB
            for i, lm in zip(picked, fan_landmarks(self.fan, rgb, np.stack(boxes),
                                                   batch=self.batch)):
                out[i] = lm
        return out


class CenterFaceLandmarker:
    """Weights-free fallback: assume a centered face spanning `fill` of the
    frame and place the canonical mean face in that box."""

    def __init__(self, fill: float = 0.8):
        self.fill = fill
        self._canon = canonical_mean_face(256)

    def __call__(self, frames: np.ndarray) -> List[Optional[np.ndarray]]:
        T, H, W = frames.shape[:3]
        side = self.fill * min(H, W)
        scale = side / 256.0
        offset = np.array([(W - side) / 2.0, (H - side) / 2.0])
        lm = self._canon * scale + offset
        return [lm.copy() for _ in range(T)]


def build_detector(
    name: str = "auto",
    device="cuda",
    retinaface_weights: Optional[str] = None,
    fan_weights: Optional[str] = None,
) -> LandmarksDetector:
    """The JAX package's decision table, with `torch` for its `jax` (which
    stays accepted as a synonym): `auto` or `torch` with both weight files
    builds `TorchLandmarksDetector` on `device`; `torch` without them
    raises; `auto` or `ibug` try the ibug packages; `auto` then falls back,
    as does `center`, to `CenterFaceLandmarker`."""
    if name == "jax":
        name = "torch"
    if name in ("auto", "torch") and retinaface_weights and fan_weights:
        return TorchLandmarksDetector(retinaface_weights, fan_weights, device=device)
    if name == "torch":
        raise ValueError("--detector torch needs --retinaface-weights and --fan-weights")
    if name in ("auto", "ibug"):
        try:
            return IbugLandmarksDetector(device)
        except Exception:
            if name == "ibug":
                raise
    return CenterFaceLandmarker()
