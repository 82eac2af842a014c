"""Parameter-tree conventions and the shared linear layer
(port of `omni_avsr_tpu/models/common.py`).

Models are plain functions over nested dicts of tensors, in the JAX
package's layout: a linear weight is (in, out) and applies as `x @ w`;
stacked layers carry a leading (L, ...) axis; weight-only int8 leaves are
{"w": int8 (in, out), "s": f32 (out,)}.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

Params = Dict[str, Any]


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w.astype(x.dtype) with an f32 result, the JAX package's
    `preferred_element_type=jnp.float32` product: the operands' values
    (bf16 activations, int8 codes) are exact in f32, so an f32 matmul over
    them accumulates the same products."""
    if w.dtype != torch.int8:
        w = w.to(x.dtype)
    return torch.matmul(x.float(), w.float())


def linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    """p = {"w": (in, out)[, "b": (out,)]}, or an int8 leaf {"w", "s"[, "b"]}
    whose per-channel scale applies to the f32 product
    (`omni_avsr_tpu/models/common.py:42-47`). The int8 product is a
    dequantise plus torch.matmul here; a hand-written int8 kernel replaces
    it in a later slice."""
    w = p["w"]
    if w.dtype == torch.int8:
        y = (matmul_f32(x, w) * p["s"].float()).to(x.dtype)
    else:
        y = torch.matmul(x, w.to(x.dtype))
    b = p.get("b")
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def layer_slice(stacked: Params, i: int) -> Params:
    """Layer i of an (L, ...)-stacked subtree."""
    return {k: (layer_slice(v, i) if isinstance(v, dict) else v[i])
            for k, v in stacked.items()}

