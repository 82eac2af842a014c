"""Torch-checkpoint converters for the preprocessing detector stack (port
of `omni_avsr_tpu/convert/detector_torch.py`, the same trees bit for bit):
RetinaFace-ResNet50 (biubug6/Pytorch_Retinaface `cfg_re50` layout, the
network behind `ibug.face_detection.RetinaFacePredictor("resnet50")`) and
FAN (1adrianb/face-alignment layout, behind
`ibug.face_alignment.FANPredictor`). See
`preprocessing_inference_example/detector.py:15-22`.

Frozen BatchNorms are folded into per-channel (scale, bias) applied after
the conv: inference-only models, running stats by definition. Conv weights
transpose (out, in, kh, kw) -> (kh, kw, in, out), the JAX package's layout;
`preprocess/retinaface.py::conv_layout` lays a tree out for the device once.

`init_retinaface` / `init_fan` make random trees of the converters' exact
layout from a numpy `RandomState`, equal to the JAX package's, so the
detector path runs without the (not redistributable) weight files. A tree
made by the JAX package (numpy arrays) moves to the port with
`bridge.params_from_numpy`, as every other tree does. `retinaface_state_dict`
and `fan_state_dict` go the other way, to a state dict in the public
layout (BN as weight = scale, bias, mean 0, variance 1 - eps), which the
converters read back to the same tree within float32 rounding.
"""


from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

_EPS = 1e-5


def _t(w: np.ndarray) -> np.ndarray:
    return np.asarray(w, np.float32).transpose(2, 3, 1, 0)


def _fold_bn(sd: Mapping[str, Any], key: str) -> Dict[str, np.ndarray]:
    g = np.asarray(sd[f"{key}.weight"], np.float32)
    b = np.asarray(sd[f"{key}.bias"], np.float32)
    m = np.asarray(sd[f"{key}.running_mean"], np.float32)
    v = np.asarray(sd[f"{key}.running_var"], np.float32)
    scale = g / np.sqrt(v + _EPS)
    return {"scale": scale, "bias": b - m * scale}


def _conv_bn(sd, conv_key: str, bn_key: str) -> Dict[str, np.ndarray]:
    return {"w": _t(sd[f"{conv_key}.weight"]), **_fold_bn(sd, bn_key)}


def _seq_conv_bn(sd, key: str) -> Dict[str, np.ndarray]:
    """nn.Sequential(conv, bn[, act]) as used by Pytorch_Retinaface."""
    return _conv_bn(sd, f"{key}.0", f"{key}.1")


def _conv_bias(sd, key: str) -> Dict[str, np.ndarray]:
    return {"w": _t(sd[f"{key}.weight"]),
            "b": np.asarray(sd[f"{key}.bias"], np.float32)}


# ------------------------------------------------------------- RetinaFace


_R50_BLOCKS = (3, 4, 6, 3)


def convert_retinaface(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """biubug6 `Retinaface(cfg_re50)` state dict -> the folded tree
    (preprocess/retinaface.py). Key roots: body.* (torchvision resnet50),
    fpn.*, ssh1/2/3.*, ClassHead/BboxHead/LandmarkHead.{i}.conv1x1."""
    sd = {k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in sd.items()}
    body: Dict[str, Any] = {
        "stem": _conv_bn(sd, "body.conv1", "body.bn1"),
        "layers": [],
    }
    for li, n in enumerate(_R50_BLOCKS):
        blocks = []
        for bi in range(n):
            p = f"body.layer{li+1}.{bi}"
            blk = {
                "conv1": _conv_bn(sd, f"{p}.conv1", f"{p}.bn1"),
                "conv2": _conv_bn(sd, f"{p}.conv2", f"{p}.bn2"),
                "conv3": _conv_bn(sd, f"{p}.conv3", f"{p}.bn3"),
            }
            if f"{p}.downsample.0.weight" in sd:
                blk["downsample"] = _conv_bn(
                    sd, f"{p}.downsample.0", f"{p}.downsample.1")
            blocks.append(blk)
        body["layers"].append(blocks)

    fpn = {name: _seq_conv_bn(sd, f"fpn.{name}")
           for name in ("output1", "output2", "output3", "merge1", "merge2")}

    def ssh(root: str) -> Dict[str, Any]:
        return {
            "conv3x3": _seq_conv_bn(sd, f"{root}.conv3X3"),
            "conv5x5_1": _seq_conv_bn(sd, f"{root}.conv5X5_1"),
            "conv5x5_2": _seq_conv_bn(sd, f"{root}.conv5X5_2"),
            "conv7x7_2": _seq_conv_bn(sd, f"{root}.conv7X7_2"),
            "conv7x7_3": _seq_conv_bn(sd, f"{root}.conv7x7_3"),
        }

    heads = {"class_head": [], "bbox_head": [], "landmark_head": []}
    for i in range(3):
        heads["class_head"].append(_conv_bias(sd, f"ClassHead.{i}.conv1x1"))
        heads["bbox_head"].append(_conv_bias(sd, f"BboxHead.{i}.conv1x1"))
        heads["landmark_head"].append(
            _conv_bias(sd, f"LandmarkHead.{i}.conv1x1"))

    return {"body": body, "fpn": fpn,
            "ssh1": ssh("ssh1"), "ssh2": ssh("ssh2"), "ssh3": ssh("ssh3"),
            **heads}


def init_retinaface(seed: int = 0) -> Dict[str, Any]:
    """Random tree with the converter's exact layout (resnet50 geometry)."""
    rng = np.random.RandomState(seed)

    def he(cin, cout, k):  # He init: keeps ~50 stacked convs finite
        return (rng.randn(k, k, cin, cout)
                * np.sqrt(2.0 / (k * k * cin))).astype(np.float32)

    def conv(cin, cout, k):
        return {"w": he(cin, cout, k),
                "scale": np.ones(cout, np.float32),
                "bias": np.zeros(cout, np.float32)}

    def head(cin, out):
        return {"w": he(cin, out, 1), "b": np.zeros(out, np.float32)}

    widths = (64, 128, 256, 512)
    body = {"stem": conv(3, 64, 7), "layers": []}
    cin = 64
    for li, n in enumerate(_R50_BLOCKS):
        planes = widths[li]
        blocks = []
        for bi in range(n):
            blk = {"conv1": conv(cin, planes, 1),
                   "conv2": conv(planes, planes, 3),
                   "conv3": conv(planes, planes * 4, 1)}
            if bi == 0:
                blk["downsample"] = conv(cin, planes * 4, 1)
            blocks.append(blk)
            cin = planes * 4
        body["layers"].append(blocks)
    fpn_in = (512, 1024, 2048)
    fpn = {f"output{i+1}": conv(fpn_in[i], 256, 1) for i in range(3)}
    fpn.update({f"merge{i}": conv(256, 256, 3) for i in (1, 2)})

    def ssh():
        return {"conv3x3": conv(256, 128, 3), "conv5x5_1": conv(256, 64, 3),
                "conv5x5_2": conv(64, 64, 3), "conv7x7_2": conv(64, 64, 3),
                "conv7x7_3": conv(64, 64, 3)}

    A = 2  # anchors per position
    return {
        "body": body, "fpn": fpn,
        "ssh1": ssh(), "ssh2": ssh(), "ssh3": ssh(),
        "class_head": [head(256, A * 2) for _ in range(3)],
        "bbox_head": [head(256, A * 4) for _ in range(3)],
        "landmark_head": [head(256, A * 10) for _ in range(3)],
    }


# -------------------------------------------------------------------- FAN


def _conv_block(sd, root: str, cin: int, cout: int) -> Dict[str, Any]:
    p = {
        "bn1": _fold_bn(sd, f"{root}.bn1"),
        "conv1": _t(sd[f"{root}.conv1.weight"]),
        "bn2": _fold_bn(sd, f"{root}.bn2"),
        "conv2": _t(sd[f"{root}.conv2.weight"]),
        "bn3": _fold_bn(sd, f"{root}.bn3"),
        "conv3": _t(sd[f"{root}.conv3.weight"]),
    }
    if f"{root}.downsample.2.weight" in sd:  # Sequential(bn, relu, conv1x1)
        p["down_bn"] = _fold_bn(sd, f"{root}.downsample.0")
        p["down"] = _t(sd[f"{root}.downsample.2.weight"])
    return p


def _hourglass(sd, root: str, depth: int = 4) -> Dict[str, Any]:
    out = {}
    for lv in range(depth, 0, -1):
        for name in ("b1_", "b2_", "b3_"):
            out[f"{name}{lv}"] = _conv_block(sd, f"{root}.{name}{lv}", 256, 256)
        if lv == 1:
            out[f"b2_plus_{lv}"] = _conv_block(sd, f"{root}.b2_plus_{lv}", 256, 256)
    return out


def convert_fan(sd: Mapping[str, Any], num_modules: int = 2) -> Dict[str, Any]:
    """1adrianb FAN state dict -> the folded tree (preprocess/fan.py)."""
    sd = {k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in sd.items()}
    params: Dict[str, Any] = {
        "conv1": _conv_bias(sd, "conv1"),
        "bn1": _fold_bn(sd, "bn1"),
        "conv2": _conv_block(sd, "conv2", 64, 128),
        "conv3": _conv_block(sd, "conv3", 128, 128),
        "conv4": _conv_block(sd, "conv4", 128, 256),
        "modules": [],
    }
    for i in range(num_modules):
        m = {
            "hg": _hourglass(sd, f"m{i}"),
            "top_m": _conv_block(sd, f"top_m_{i}", 256, 256),
            "conv_last": _conv_bias(sd, f"conv_last{i}"),
            "bn_end": _fold_bn(sd, f"bn_end{i}"),
            "l": _conv_bias(sd, f"l{i}"),
        }
        if i < num_modules - 1:
            m["bl"] = _conv_bias(sd, f"bl{i}")
            m["al"] = _conv_bias(sd, f"al{i}")
        params["modules"].append(m)
    return params


def init_fan(seed: int = 0, num_modules: int = 2) -> Dict[str, Any]:
    """Random tree with the converter's exact layout."""
    rng = np.random.RandomState(seed)

    def conv(cin, cout, k):  # He init (see init_retinaface)
        return (rng.randn(k, k, cin, cout)
                * np.sqrt(2.0 / (k * k * cin))).astype(np.float32)

    def bn(c):
        return {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)}

    def block(cin, cout):
        p = {"bn1": bn(cin), "conv1": conv(cin, cout // 2, 3),
             "bn2": bn(cout // 2), "conv2": conv(cout // 2, cout // 4, 3),
             "bn3": bn(cout // 4), "conv3": conv(cout // 4, cout // 4, 3)}
        if cin != cout:
            p["down_bn"] = bn(cin)
            p["down"] = conv(cin, cout, 1)
        return p

    def cb(cin, cout, k):
        return {"w": conv(cin, cout, k), "b": np.zeros(cout, np.float32)}

    def hg():
        out = {}
        for lv in range(4, 0, -1):
            for name in ("b1_", "b2_", "b3_"):
                out[f"{name}{lv}"] = block(256, 256)
            if lv == 1:
                out[f"b2_plus_{lv}"] = block(256, 256)
        return out

    params = {"conv1": cb(3, 64, 7), "bn1": bn(64),
              "conv2": block(64, 128), "conv3": block(128, 128),
              "conv4": block(128, 256), "modules": []}
    for i in range(num_modules):
        m = {"hg": hg(), "top_m": block(256, 256),
             "conv_last": cb(256, 256, 1), "bn_end": bn(256),
             "l": cb(256, 68, 1)}
        if i < num_modules - 1:
            m["bl"] = cb(256, 256, 1)
            m["al"] = cb(68, 256, 1)
        params["modules"].append(m)
    return params


# ------------------------------------------------- trees -> public layouts


def _unfold_bn(sd: Dict[str, np.ndarray], key: str, p: Mapping[str, Any]) -> None:
    c = len(p["scale"])
    sd[f"{key}.weight"] = np.asarray(p["scale"], np.float32)
    sd[f"{key}.bias"] = np.asarray(p["bias"], np.float32)
    sd[f"{key}.running_mean"] = np.zeros(c, np.float32)
    sd[f"{key}.running_var"] = np.full(c, 1.0 - _EPS, np.float32)


def _conv_w(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w, np.float32).transpose(3, 2, 0, 1))


def _unconv_bn(sd, conv_key: str, bn_key: str, p) -> None:
    sd[f"{conv_key}.weight"] = _conv_w(p["w"])
    _unfold_bn(sd, bn_key, p)


def _unconv_bias(sd, key: str, p) -> None:
    sd[f"{key}.weight"] = _conv_w(p["w"])
    sd[f"{key}.bias"] = np.asarray(p["b"], np.float32)


def retinaface_state_dict(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The folded tree -> a biubug6 `Retinaface(cfg_re50)` state dict
    (numpy), which `convert_retinaface` reads back."""
    sd: Dict[str, np.ndarray] = {}
    body = tree["body"]
    _unconv_bn(sd, "body.conv1", "body.bn1", body["stem"])
    for li, blocks in enumerate(body["layers"]):
        for bi, blk in enumerate(blocks):
            p = f"body.layer{li+1}.{bi}"
            for k in ("conv1", "conv2", "conv3"):
                _unconv_bn(sd, f"{p}.{k}", f"{p}.bn{k[-1]}", blk[k])
            if "downsample" in blk:
                _unconv_bn(sd, f"{p}.downsample.0", f"{p}.downsample.1", blk["downsample"])
    for name, p in tree["fpn"].items():
        _unconv_bn(sd, f"fpn.{name}.0", f"fpn.{name}.1", p)
    ssh_keys = {"conv3x3": "conv3X3", "conv5x5_1": "conv5X5_1", "conv5x5_2": "conv5X5_2",
                "conv7x7_2": "conv7X7_2", "conv7x7_3": "conv7x7_3"}
    for i in (1, 2, 3):
        for k, public in ssh_keys.items():
            _unconv_bn(sd, f"ssh{i}.{public}.0", f"ssh{i}.{public}.1", tree[f"ssh{i}"][k])
    for key, public in (("class_head", "ClassHead"), ("bbox_head", "BboxHead"),
                        ("landmark_head", "LandmarkHead")):
        for i, p in enumerate(tree[key]):
            _unconv_bias(sd, f"{public}.{i}.conv1x1", p)
    return sd


def _unconv_block(sd, root: str, p) -> None:
    for i in (1, 2, 3):
        _unfold_bn(sd, f"{root}.bn{i}", p[f"bn{i}"])
        sd[f"{root}.conv{i}.weight"] = _conv_w(p[f"conv{i}"])
    if "down" in p:  # Sequential(bn, relu, conv1x1)
        _unfold_bn(sd, f"{root}.downsample.0", p["down_bn"])
        sd[f"{root}.downsample.2.weight"] = _conv_w(p["down"])


def fan_state_dict(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The folded tree -> a 1adrianb FAN state dict (numpy), which
    `convert_fan` reads back."""
    sd: Dict[str, np.ndarray] = {}
    _unconv_bias(sd, "conv1", tree["conv1"])
    _unfold_bn(sd, "bn1", tree["bn1"])
    for k in ("conv2", "conv3", "conv4"):
        _unconv_block(sd, k, tree[k])
    for i, m in enumerate(tree["modules"]):
        for name, p in m["hg"].items():
            _unconv_block(sd, f"m{i}.{name}", p)
        _unconv_block(sd, f"top_m_{i}", m["top_m"])
        _unconv_bias(sd, f"conv_last{i}", m["conv_last"])
        _unfold_bn(sd, f"bn_end{i}", m["bn_end"])
        _unconv_bias(sd, f"l{i}", m["l"])
        if "bl" in m:
            _unconv_bias(sd, f"bl{i}", m["bl"])
            _unconv_bias(sd, f"al{i}", m["al"])
    return sd
