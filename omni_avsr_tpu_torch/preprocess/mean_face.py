"""Canonical 68-point mean-face landmarks (port of
`omni_avsr_tpu/preprocess/mean_face.py`, the same numbers bit for bit).

The reference warps every frame to a reference face (`20words_mean_face.npy`,
`preprocessing_inference_example/video_process.py:56-66`). That asset is not
redistributable here, so this is a standard iBUG-68 neutral-face layout in
the same coordinate convention (256x256 crop space). For bit-exact parity
with reference-preprocessed corpora, pass the original file via
`--mean-face-path`.
"""

from __future__ import annotations

import numpy as np


def canonical_mean_face(size: int = 256) -> np.ndarray:
    """(68, 2) landmarks of a neutral frontal face in [0, size)^2, laid out
    per the iBUG-68 annotation scheme."""
    s = size / 256.0
    pts = []

    # 0-16 jawline: ellipse arc from left temple to right temple
    cx, cy = 128.0, 120.0
    for i in range(17):
        ang = np.pi * (1.0 - i / 16.0)  # pi .. 0
        x = cx + 78.0 * np.cos(ang)
        y = cy + 95.0 * np.sin(ang) * (0.55 + 0.45 * np.sin(ang))
        pts.append((x, y))

    # 17-21 right... (image-left) eyebrow, 22-26 image-right eyebrow
    for i in range(5):
        pts.append((66.0 + i * 12.0, 92.0 - 6.0 * np.sin(np.pi * i / 4.0)))
    for i in range(5):
        pts.append((142.0 + i * 12.0, 92.0 - 6.0 * np.sin(np.pi * i / 4.0)))

    # 27-30 nose bridge, 31-35 nostrils
    for i in range(4):
        pts.append((128.0, 104.0 + i * 11.0))
    for i in range(5):
        pts.append((116.0 + i * 6.0, 146.0))

    # 36-41 left eye, 42-47 right eye (6-point loops)
    def eye(cx_, cy_):
        w, h = 14.0, 5.0
        out = []
        for k, ang in enumerate(np.linspace(0, 2 * np.pi, 7)[:-1]):
            out.append((cx_ + w * np.cos(ang), cy_ + h * np.sin(ang)))
        return out

    pts += eye(96.0, 106.0)
    pts += eye(160.0, 106.0)

    # 48-59 outer lip (12 pts), 60-67 inner lip (8 pts), mouth center ~(128, 178)
    mx, my = 128.0, 178.0
    for k, ang in enumerate(np.linspace(0, 2 * np.pi, 13)[:-1]):
        pts.append((mx + 24.0 * np.cos(ang), my + 11.0 * np.sin(ang)))
    for k, ang in enumerate(np.linspace(0, 2 * np.pi, 9)[:-1]):
        pts.append((mx + 14.0 * np.cos(ang), my + 5.0 * np.sin(ang)))

    return (np.asarray(pts, np.float64) * s).astype(np.float64)


def load_mean_face(path: str | None = None, size: int = 256) -> np.ndarray:
    if path:
        return np.load(path).astype(np.float64)
    return canonical_mean_face(size)
