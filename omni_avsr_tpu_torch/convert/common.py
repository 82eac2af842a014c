"""Shared helpers for converting PyTorch reference checkpoints into the
port's parameter tree (port of `omni_avsr_tpu/convert/common.py`).

The port's tree has the JAX package's layout: linear weights as (in, out),
convolutions channels-last (WIO, HWIO, DHWIO), per-layer leaves stacked
along a leading layer axis. The rearranging is host-side numpy in f32, as
in the JAX package, so both give the same bits; `to_torch` then casts the
finished tree to torch tensors on the CPU, and the caller moves it to the
device.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def t2n(x: Any) -> np.ndarray:
    """torch.Tensor | np.ndarray -> f32 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def to_torch(tree: Dict[str, Any], dtype: torch.dtype) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same dict of `dtype` tensors."""
    return {k: to_torch(v, dtype) if isinstance(v, dict)
            else torch.from_numpy(np.ascontiguousarray(v)).to(dtype)
            for k, v in tree.items()}


def linear_from_torch(sd: Mapping[str, Any], prefix: str, bias: bool = True) -> Dict[str, np.ndarray]:
    """nn.Linear (out, in) -> {"w": (in, out)[, "b": (out,)]}."""
    out = {"w": t2n(sd[f"{prefix}.weight"]).T}
    if bias and f"{prefix}.bias" in sd:
        out["b"] = t2n(sd[f"{prefix}.bias"])
    return out


def layer_norm_from_torch(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": t2n(sd[f"{prefix}.weight"]), "bias": t2n(sd[f"{prefix}.bias"])}


def rms_norm_from_torch(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": t2n(sd[f"{prefix}.weight"])}


def conv1d_from_torch(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """Conv1d weight (O, I, K) -> (K, I, O)."""
    out = {"w": t2n(sd[f"{prefix}.weight"]).transpose(2, 1, 0)}
    if f"{prefix}.bias" in sd:
        out["b"] = t2n(sd[f"{prefix}.bias"])
    return out


def conv2d_from_torch(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """Conv2d weight (O, I, Kh, Kw) -> (Kh, Kw, I, O)."""
    out = {"w": t2n(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0)}
    if f"{prefix}.bias" in sd:
        out["b"] = t2n(sd[f"{prefix}.bias"])
    return out


def conv3d_from_torch(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """Conv3d weight (O, I, Kt, Kh, Kw) -> (Kt, Kh, Kw, I, O)."""
    out = {"w": t2n(sd[f"{prefix}.weight"]).transpose(2, 3, 4, 1, 0)}
    if f"{prefix}.bias" in sd:
        out["b"] = t2n(sd[f"{prefix}.bias"])
    return out


def batch_norm_from_torch(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": t2n(sd[f"{prefix}.weight"]), "bias": t2n(sd[f"{prefix}.bias"]),
            "mean": t2n(sd[f"{prefix}.running_mean"]), "var": t2n(sd[f"{prefix}.running_var"])}


def stack_dicts(dicts) -> Dict[str, Any]:
    """Per-layer nested dicts -> one dict of arrays with a leading layer axis."""
    first = dicts[0]
    if isinstance(first, dict):
        return {k: stack_dicts([d[k] for d in dicts]) for k in first}
    return np.stack(dicts, axis=0)
