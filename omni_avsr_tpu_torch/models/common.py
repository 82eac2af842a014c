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

from typing import Any, Dict, Iterator, Sequence, Tuple

import torch

from ..ops.quant import layer_slice, quantized_matmul, quantized_matmul4  # noqa: F401
from ..parallel import collectives as par

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


def tp_ffn(h: torch.Tensor, fc1: Params, fc2: Params, block: str, act,
           mid=lambda h: h) -> torch.Tensor:
    """act(h @ fc1) @ fc2 (`mid` applied between, e.g. a dropout), with the
    serving tree's encoder FFN tensor-parallel when `block` runs so: fc1's
    column slice, fc2's row slice, the partial products all-reduced over tp
    before fc2's bias."""
    tp = par.tp_axis(block)
    if tp is None:
        return linear(mid(act(linear(h, fc1))), fc2)
    h = mid(act(linear(par.copy_to(h, tp), fc1)))
    y = par.reduce_from(linear(h, {k: v for k, v in fc2.items() if k != "b"}), tp)
    b = fc2.get("b")
    return y + b.to(y.dtype) if b is not None else y


def stack_layers(layer_params: Sequence[Params]) -> Params:
    """Per-layer trees stacked along a new leading (L, ...) axis."""
    first = layer_params[0]
    if isinstance(first, dict):
        return {k: stack_layers([p[k] for p in layer_params]) for k in first}
    return torch.stack(list(layer_params), dim=0)


def tree_paths(params: Params, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(dotted path, leaf) of every leaf, in the tree's order."""
    for k, v in params.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from tree_paths(v, path)
        else:
            yield path, v


def count_params(params: Params) -> int:
    """The number of elements over every leaf."""
    return sum(int(v.numel()) for _, v in tree_paths(params))


def cast_tree(params: Params, dtype: torch.dtype) -> Params:
    """The tree with its floating leaves in `dtype`; integer leaves (int8
    codes) as they are."""
    return {k: cast_tree(v, dtype) if isinstance(v, dict)
            else v.to(dtype) if v.is_floating_point() else v for k, v in params.items()}
