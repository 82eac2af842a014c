"""RetinaFace (ResNet-50) face detector in PyTorch (port of
`omni_avsr_tpu/preprocess/retinaface.py`).

The reference detects faces with `ibug.face_detection.RetinaFacePredictor`
(`preprocessing_inference_example/detector.py:15-22`, threshold 0.8, model
"resnet50"), the biubug6/Pytorch_Retinaface `cfg_re50` network:

  body.*            torchvision ResNet-50 (C3/C4/C5 = layer2/3/4)
  fpn.output{1,2,3} 1x1 lateral conv+BN (256) ; fpn.merge{1,2} 3x3 conv+BN
  ssh{1,2,3}        context module: 3x3 | 5x5(2x3x3) | 7x7(3x3x3) concat
  ClassHead/BboxHead/LandmarkHead  1x1 convs -> (A*2 / A*4 / A*10)

Anchors: min_sizes [[16,32],[64,128],[256,512]], steps [8,16,32],
variances [0.1, 0.2] (cfg_re50); SSD-style decode; host-side NMS.

The network is plain functions over the folded tree the converters make
(`convert/detector_torch.py`, the JAX package's layout). `conv_layout` lays
it out once for the device: HWIO weights to OIHW (channels_last on the
card), each frozen BN's per-channel scale folded into its conv's weights and
its shift into the conv's bias. Convs run in f32 through
`torch.nn.functional.conv2d`, as the JAX forward runs `conv_general_dilated`
outside any Pallas kernel. `detect_faces` runs a clip's frames in batches;
the decode, thresholds and NMS stay on the host, per frame, as in the JAX
package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]

MIN_SIZES = ((16, 32), (64, 128), (256, 512))
STEPS = (8, 16, 32)
VARIANCES = (0.1, 0.2)
MEAN_BGR = (104.0, 117.0, 123.0)  # the biubug6/ibug preprocessing


def conv_layout(tree: Any, device) -> Any:
    """A detector tree in the JAX layout (numpy or torch leaves, HWIO conv
    weights) -> the same tree for `device`: OIHW conv weights (channels_last
    on CUDA), `{"w", "scale", "bias"}` folded to `{"w", "b"}`, and BN
    `{"scale", "bias"}` pairs shaped (C, 1, 1). Runs once per detector."""
    dev = torch.device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=torch.float32).to(dev)

    def oihw(w, scale=None):
        w = t(w).permute(3, 2, 0, 1)
        if scale is not None:
            w = w * t(scale)[:, None, None, None]
        fmt = torch.channels_last if dev.type == "cuda" else torch.contiguous_format
        return w.contiguous(memory_format=fmt)

    def walk(node):
        if isinstance(node, list):
            return [walk(v) for v in node]
        if not isinstance(node, dict):
            return oihw(node) if np.ndim(node) == 4 else t(node)
        keys = set(node)
        if keys == {"w", "scale", "bias"}:
            return {"w": oihw(node["w"], node["scale"]), "b": t(node["bias"])}
        if keys == {"w", "b"}:
            return {"w": oihw(node["w"]), "b": t(node["b"])}
        if keys == {"scale", "bias"}:
            return {k: t(node[k])[:, None, None] for k in ("scale", "bias")}
        return {k: walk(v) for k, v in node.items()}

    return walk(tree)


def conv2d(x: torch.Tensor, w: torch.Tensor, b=None, stride: int = 1, padding=None) -> torch.Tensor:
    """NCHW conv with an OIHW weight, "same" padding k // 2 by default."""
    return F.conv2d(x, w, b, stride, w.shape[-1] // 2 if padding is None else padding)


def conv_bn(x: torch.Tensor, p: Params, stride: int = 1, relu: bool = True,
            leaky: float = 0.0) -> torch.Tensor:
    """Conv with the frozen BN folded in (+ ReLU, or LeakyReLU)."""
    y = conv2d(x, p["w"], p["b"], stride)
    if relu:
        y = F.leaky_relu(y, leaky) if leaky else F.relu(y)
    return y


def _bottleneck(x: torch.Tensor, p: Params, stride: int) -> torch.Tensor:
    h = conv_bn(x, p["conv1"])
    h = conv_bn(h, p["conv2"], stride=stride)
    h = conv_bn(h, p["conv3"], relu=False)
    if "downsample" in p:
        x = conv_bn(x, p["downsample"], stride=stride, relu=False)
    return F.relu(x + h)


def resnet50_c345(x: torch.Tensor, p: Params) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """torchvision ResNet-50 trunk -> (C3 /8 512ch, C4 /16 1024ch, C5 /32 2048ch)."""
    h = conv_bn(x, p["stem"], stride=2)  # 7x7/2
    h = F.max_pool2d(h, 3, 2, 1)
    outs = []
    for li, blocks in enumerate(p["layers"]):
        for bi, blk in enumerate(blocks):
            h = _bottleneck(h, blk, stride=(2 if bi == 0 and li > 0 else 1))
        outs.append(h)
    return outs[1], outs[2], outs[3]


def _upsample_to(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize to (H, W): source index i * h // H."""
    H, W = hw
    h_idx = torch.arange(H, device=x.device) * x.shape[2] // H
    w_idx = torch.arange(W, device=x.device) * x.shape[3] // W
    return x[:, :, h_idx][:, :, :, w_idx]


def _ssh(x: torch.Tensor, p: Params) -> torch.Tensor:
    c3 = conv_bn(x, p["conv3x3"], relu=False)
    h5 = conv_bn(x, p["conv5x5_1"])
    c5 = conv_bn(h5, p["conv5x5_2"], relu=False)
    h7 = conv_bn(h5, p["conv7x7_2"])
    c7 = conv_bn(h7, p["conv7x7_3"], relu=False)
    return F.relu(torch.cat([c3, c5, c7], dim=1))


def _head(x: torch.Tensor, p: Params, out_per_anchor: int) -> torch.Tensor:
    y = conv2d(x, p["w"], p["b"], padding=0)
    return y.permute(0, 2, 3, 1).reshape(x.shape[0], -1, out_per_anchor)


def retinaface_forward(params: Params, images: torch.Tensor):
    """(B, H, W, 3) f32 BGR, mean-subtracted (104, 117, 123), on the
    parameters' device -> (loc (B, A, 4), conf (B, A, 2) softmaxed, ldm
    (B, A, 10)). `params` is a `conv_layout` tree."""
    x = images.permute(0, 3, 1, 2)  # NCHW view; channels_last in memory
    c3, c4, c5 = resnet50_c345(x, params["body"])
    f = params["fpn"]
    o1 = conv_bn(c3, f["output1"])
    o2 = conv_bn(c4, f["output2"])
    o3 = conv_bn(c5, f["output3"])
    o2 = conv_bn(o2 + _upsample_to(o3, o2.shape[2:]), f["merge2"])
    o1 = conv_bn(o1 + _upsample_to(o2, o1.shape[2:]), f["merge1"])
    feats = [_ssh(o, params[f"ssh{i + 1}"]) for i, o in enumerate((o1, o2, o3))]
    loc = torch.cat([_head(ft, params["bbox_head"][i], 4) for i, ft in enumerate(feats)], 1)
    conf = torch.cat([_head(ft, params["class_head"][i], 2) for i, ft in enumerate(feats)], 1)
    ldm = torch.cat([_head(ft, params["landmark_head"][i], 10) for i, ft in enumerate(feats)], 1)
    return loc, torch.softmax(conf, dim=-1), ldm


# ----------------------------------------------------------- anchors / boxes


def priors_for(height: int, width: int) -> np.ndarray:
    """PriorBox(cfg_re50) anchors in (cx, cy, sx, sy) normalized form."""
    out = []
    for sizes, step in zip(MIN_SIZES, STEPS):
        fh = -(-height // step)
        fw = -(-width // step)
        # PriorBox order: product(range(fh), range(fw)) x min_sizes, rows
        # major, then columns, then size: the heads' flattening
        i, j, s = np.meshgrid(np.arange(fh), np.arange(fw), np.arange(len(sizes)), indexing="ij")
        i, j, s = [a.reshape(-1) for a in (i, j, s)]
        sk = np.asarray(sizes)[s]
        out.append(np.stack([(j + 0.5) * step / width, (i + 0.5) * step / height,
                             sk / width, sk / height], axis=-1))
    return np.concatenate(out, axis=0).astype(np.float32)


def decode_boxes(loc: np.ndarray, priors: np.ndarray) -> np.ndarray:
    """SSD decode (variances 0.1/0.2) -> corner-form normalized boxes. The
    exp argument is clamped to +-10, so unconverged or random weights cannot
    overflow to inf."""
    cxy = priors[:, :2] + loc[:, :2] * VARIANCES[0] * priors[:, 2:]
    wh = priors[:, 2:] * np.exp(np.clip(loc[:, 2:] * VARIANCES[1], -10.0, 10.0))
    return np.concatenate([cxy - wh / 2, cxy + wh / 2], axis=-1)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float = 0.4) -> List[int]:
    """Greedy IoU NMS (host-side; the py_cpu_nms semantics)."""
    x1, y1, x2, y2 = boxes.T
    areas = (x2 - x1) * (y2 - y1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0.0, xx2 - xx1) * np.maximum(0.0, yy2 - yy1)
        iou = inter / (areas[i] + areas[order[1:]] - inter + 1e-12)
        order = order[1:][iou <= iou_thresh]
    return keep


def frame_faces(loc: np.ndarray, scores: np.ndarray, priors: np.ndarray, H: int, W: int,
                threshold: float = 0.8, iou_thresh: float = 0.4) -> np.ndarray:
    """One frame's (A, 4) regressions and (A,) face scores -> (N, 5) [x1, y1,
    x2, y2, score] in pixels, score-sorted. Non-finite or degenerate boxes
    are dropped before NMS, so garbage regressions surface as no detection."""
    boxes = decode_boxes(loc, priors) * np.array([W, H, W, H], np.float32)
    keep = ((scores > threshold) & np.isfinite(boxes).all(axis=1)
            & (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1]))
    boxes, scores = boxes[keep], scores[keep]
    if len(boxes) == 0:
        return np.zeros((0, 5), np.float32)
    order = nms(boxes, scores, iou_thresh)
    return np.concatenate([boxes[order], scores[order, None]], axis=-1)


def detect_faces(params: Params, frames_bgr: torch.Tensor, threshold: float = 0.8,
                 iou_thresh: float = 0.4, batch: int = 32) -> List[np.ndarray]:
    """(T, H, W, 3) uint8 BGR frames on the parameters' device -> per frame
    the (N, 5) faces of the JAX `detect_faces` (`:168-219`). The network
    runs `batch` frames at a time."""
    T, H, W = frames_bgr.shape[:3]
    mean = torch.tensor(MEAN_BGR, device=frames_bgr.device)
    priors = priors_for(H, W)
    out: List[np.ndarray] = []
    with torch.inference_mode():
        for i in range(0, T, batch):
            x = frames_bgr[i:i + batch].to(torch.float32) - mean
            loc, conf, _ = retinaface_forward(params, x)
            loc, scores = loc.cpu().numpy(), conf[..., 1].cpu().numpy()
            out += [frame_faces(loc[b], scores[b], priors, H, W, threshold, iou_thresh)
                    for b in range(len(loc))]
    return out
