"""Parameter-tree conventions and the shared linear layer
(port of `omni_avsr_tpu/models/common.py`).

Models are plain functions over nested dicts of tensors, in the JAX
package's layout: a linear weight is (in, out) and applies as `x @ w`;
stacked layers carry a leading (L, ...) axis; weight-only int8 leaves are
{"w": int8 (in, out), "s": f32 (out,)} (or {"wc", "s"} in the card
layout) and packed-int4 leaves
{"w4": int8 (in, chunks, block_n/2), "s": f32 (out,)} (or {"w4c", "s"} in
the card layout) (`ops/quant.py`).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..ops.quant import quantized_matmul, quantized_matmul4

Params = Dict[str, Any]


def linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    """p = {"w": (in, out)[, "b": (out,)]}; an int8 leaf {"w" or "wc", "s"[,
    "b"]} goes through `quantized_matmul` (B2) and a packed-int4 leaf
    {"w4" or "w4c", "s"[, "b"]} through `quantized_matmul4` (B6), the per-channel
    scale applied to the f32 accumulator
    (`omni_avsr_tpu/models/common.py:30-47`); on CPU tensors both take
    their plain versions."""
    int4 = "w4" in p or "w4c" in p
    if int4 or "wc" in p or p["w"].dtype == torch.int8:
        lead = x.shape[:-1]
        xm = x.reshape(-1, x.shape[-1]).contiguous()
        y = quantized_matmul4(xm, p) if int4 else quantized_matmul(xm, p)
        y = y.reshape(*lead, -1)
    else:
        y = torch.matmul(x, p["w"].to(x.dtype))
    b = p.get("b")
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def layer_slice(stacked: Params, i: int) -> Params:
    """Layer i of an (L, ...)-stacked subtree."""
    return {k: (layer_slice(v, i) if isinstance(v, dict) else v[i])
            for k, v in stacked.items()}

