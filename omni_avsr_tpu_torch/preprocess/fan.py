"""FAN 2D 68-landmark network in PyTorch (port of
`omni_avsr_tpu/preprocess/fan.py`).

The reference localizes landmarks with `ibug.face_alignment.FANPredictor`
(`preprocessing_inference_example/detector.py:22, 28`), Bulat &
Tzimiropoulos' Face Alignment Network: stacked hourglasses (depth 4) of
pre-activation ConvBlocks, in the public 1adrianb/face-alignment layout
(conv1/bn1, conv2-4 ConvBlocks, m{i}/top_m_{i}/conv_last{i}/bn_end{i}/
l{i}/bl{i}/al{i} per hourglass module).

Pipeline (FANPredictor semantics): crop the detected face box to a 256x256
patch around its center (scale from the box size), run the network, take
each of the 68 heatmaps' argmax at 64x64 with the classic quarter-pixel
offset toward the stronger neighbour, and map back to image coordinates
through the inverse crop. The crop constants live in `CropSpec`.

On the device: `crop_faces` crops every face box of a clip at once
(bilinear, zero outside the frame), `fan_forward` runs the crops in
batches, and `heatmaps_to_landmarks` takes the argmax and the neighbours'
signs there; the last affine map runs on the host in float64. The tree is
the converters' folded tree laid out by `retinaface.conv_layout`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .retinaface import conv2d

Params = Dict[str, object]


def _bn_relu(x: torch.Tensor, p: Params) -> torch.Tensor:
    return F.relu(x * p["scale"] + p["bias"])


def conv_block(x: torch.Tensor, p: Params) -> torch.Tensor:
    """FAN pre-activation ConvBlock: three bn-relu-conv stages producing
    out/2, out/4, out/4 channels, concatenated, plus a (projected) skip."""
    h1 = conv2d(_bn_relu(x, p["bn1"]), p["conv1"])
    h2 = conv2d(_bn_relu(h1, p["bn2"]), p["conv2"])
    h3 = conv2d(_bn_relu(h2, p["bn3"]), p["conv3"])
    out = torch.cat([h1, h2, h3], dim=1)
    skip = x
    if "down" in p:
        skip = conv2d(_bn_relu(x, p["down_bn"]), p["down"], padding=0)
    return out + skip


def hourglass(x: torch.Tensor, p: Params, level: int = 4) -> torch.Tensor:
    """Recursive hourglass: up branch + pooled branch (recurse), nearest
    2x upsample and add."""
    lv = str(level)
    up1 = conv_block(x, p["b1_" + lv])
    low1 = conv_block(F.avg_pool2d(x, 2, 2), p["b2_" + lv])
    if level > 1:
        low2 = hourglass(low1, p, level - 1)
    else:
        low2 = conv_block(low1, p["b2_plus_" + lv])
    low3 = conv_block(low2, p["b3_" + lv])
    return up1 + F.interpolate(low3, scale_factor=2, mode="nearest")


def fan_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """(B, 256, 256, 3) f32 in [0, 1] -> (B, 64, 64, 68) final-module
    heatmaps (a view of the NCHW result; the intermediate supervision
    outputs are not needed for inference)."""
    h = x.permute(0, 3, 1, 2)
    h = _bn_relu(conv2d(h, params["conv1"]["w"], params["conv1"]["b"], stride=2), params["bn1"])
    h = conv_block(h, params["conv2"])
    h = F.avg_pool2d(h, 2, 2)
    h = conv_block(h, params["conv3"])
    h = conv_block(h, params["conv4"])
    previous = h
    out = None
    n = len(params["modules"])
    for i, m in enumerate(params["modules"]):
        hg = hourglass(previous, m["hg"])
        ll = conv_block(hg, m["top_m"])
        ll = _bn_relu(conv2d(ll, m["conv_last"]["w"], m["conv_last"]["b"], padding=0),
                      m["bn_end"])
        out = conv2d(ll, m["l"]["w"], m["l"]["b"], padding=0)
        if i < n - 1:
            previous = (previous + conv2d(ll, m["bl"]["w"], m["bl"]["b"], padding=0)
                        + conv2d(out, m["al"]["w"], m["al"]["b"], padding=0))
    return out.permute(0, 2, 3, 1)


# --------------------------------------------------------------- crop/decode


@dataclass(frozen=True)
class CropSpec:
    """Face-box -> 256x256 crop geometry (1adrianb constants)."""

    resolution: int = 256
    heatmap: int = 64
    center_shift: float = 0.12  # center moved up by this * box height
    scale_div: float = 195.0  # scale = (w + h) / scale_div
    scale_mul: float = 200.0  # crop side = scale * scale_mul


def crop_geometry(boxes: np.ndarray, spec: CropSpec = CropSpec()) -> Tuple[np.ndarray, np.ndarray]:
    """(N, >=4) boxes -> (centers (N, 2), sides (N,)) in the boxes' dtype
    (float32 from the detector), formed as the JAX `crop_face` forms them.
    Raises ValueError on a non-finite or degenerate box: callers map that
    frame to None (landmark interpolation covers detection gaps,
    `preprocessing_inference_example/video_process.py:120-145`)."""
    b = np.asarray(boxes)[:, :4]
    x1, y1, x2, y2 = b.T
    bad = ~np.isfinite(b).all(axis=1) | (x2 <= x1) | (y2 <= y1)
    if bad.any():
        raise ValueError(f"degenerate face box {b[np.argmax(bad)]}")
    centers = np.stack([(x1 + x2) / 2.0, (y1 + y2) / 2.0], -1)
    centers[:, 1] -= (y2 - y1) * spec.center_shift
    sides = (x2 - x1 + y2 - y1) / spec.scale_div * spec.scale_mul
    return centers, sides


def crop_faces(frames_rgb: torch.Tensor, boxes: np.ndarray,
               spec: CropSpec = CropSpec()) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Crop + bilinear-resize each box of its frame to (res, res): (N, H, W,
    3) uint8 frames on the device and (N, 4) boxes -> (patches (N, res, res,
    3) f32 in [0, 1] on the device, centers (N, 2), sides (N,)). Samples
    outside the frame are zero (the 1adrianb crop zero-pads). The sampling
    grid and weights are float64, as the JAX `crop_face` forms them."""
    centers, sides = crop_geometry(boxes, spec)
    dev = frames_rgb.device
    N, H, W = frames_rgb.shape[:3]
    res = spec.resolution
    start = torch.as_tensor((centers - sides[:, None] / 2.0).astype(np.float64), device=dev)
    s = torch.as_tensor(sides.astype(np.float64), device=dev)[:, None]
    step = (torch.arange(res, device=dev, dtype=torch.float64) + 0.5)[None] * s / res
    ys, xs = start[:, 1:2] + step, start[:, 0:1] + step  # (N, res)
    y0, x0 = torch.floor(ys - 0.5), torch.floor(xs - 0.5)
    wy, wx = (ys - 0.5 - y0)[:, :, None, None], (xs - 0.5 - x0)[:, None, :, None]
    y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
    img = frames_rgb.to(torch.float32) / 255.0
    n_idx = torch.arange(N, device=dev)[:, None, None]

    def tap(yi, xi):
        valid = (((yi >= 0) & (yi < H))[:, :, None] & ((xi >= 0) & (xi < W))[:, None, :])
        g = img[n_idx, yi.clamp(0, H - 1)[:, :, None], xi.clamp(0, W - 1)[:, None, :]]
        return g.to(torch.float64) * valid[..., None]

    patch = (tap(y0, x0) * (1 - wy) * (1 - wx) + tap(y0, x0 + 1) * (1 - wy) * wx
             + tap(y0 + 1, x0) * wy * (1 - wx) + tap(y0 + 1, x0 + 1) * wy * wx)
    return patch.to(torch.float32), centers, sides


def heatmaps_to_landmarks(heatmaps: torch.Tensor, centers: np.ndarray, sides: np.ndarray,
                          spec: CropSpec = CropSpec()) -> np.ndarray:
    """(N, 64, 64, 68) heatmaps -> (N, 68, 2) float64 image-space landmarks:
    per heatmap the argmax (the first on ties) and a quarter-pixel shift
    toward the stronger neighbour, mapped back through the inverse crop."""
    hm = heatmaps.permute(0, 3, 1, 2)  # (N, 68, Hh, Wh)
    N, K, Hh, Wh = hm.shape
    idx = hm.reshape(N, K, -1).argmax(dim=-1)
    py, px = idx // Wh, idx % Wh

    def at(y, x):
        rows = hm.gather(2, y.clamp(0, Hh - 1)[..., None, None].expand(N, K, 1, Wh))[:, :, 0]
        return rows.gather(2, x.clamp(0, Wh - 1)[..., None])[..., 0]

    dx = torch.sign(at(py, px + 1) - at(py, px - 1)) * ((px > 0) & (px < Wh - 1))
    dy = torch.sign(at(py + 1, px) - at(py - 1, px)) * ((py > 0) & (py < Hh - 1))
    pts = torch.stack([px + 0.25 * dx.to(torch.float64), py + 0.25 * dy.to(torch.float64)], -1)
    ratio = (sides / spec.heatmap)[:, None, None]
    origin = centers - sides[:, None] / 2.0
    return (pts.cpu().numpy() + 0.5) * ratio + origin[:, None, :]


def fan_landmarks(params: Params, frames_rgb: torch.Tensor, boxes: np.ndarray,
                  spec: CropSpec = CropSpec(), batch: int = 32) -> np.ndarray:
    """The FANPredictor step for one face box per frame: (N, H, W, 3) uint8
    RGB frames on the device and (N, 4) boxes -> (N, 68, 2) float64
    landmarks, `batch` crops at a time. Raises ValueError on a degenerate
    box (see `crop_geometry`)."""
    out = []
    with torch.inference_mode():
        for i in range(0, len(boxes), batch):
            patches, centers, sides = crop_faces(frames_rgb[i:i + batch], boxes[i:i + batch], spec)
            out.append(heatmaps_to_landmarks(fan_forward(params, patches), centers, sides, spec))
    return np.concatenate(out) if out else np.zeros((0, 68, 2))
