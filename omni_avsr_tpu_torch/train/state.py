"""Train state: the trainable/frozen split of one parameter tree (port of
`omni_avsr_tpu/train/state.py`).

The reference trains three parameter regimes (`modeling_OmniAVSR.py:61,
148, 216, 234-260`): frozen encoders and LLM, always-trainable projectors,
and selectively unfrozen LoRA. A path predicate splits one tree into a
trainable tree, kept as f32 masters that require grad, and a frozen tree
that keeps its dtype (bf16 on the card). Each step computes with the
masters cast to the compute dtype (`cast_trainable`), so autograd returns
f32 grads to the masters: the bf16-true semantics of the JAX package's
`make_train_step` (`:78-102`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

Params = Dict[str, Any]
PathPredicate = Callable[[str], bool]


def default_trainable_predicate(path: str) -> bool:
    """Trainable = the LoRA adapters and the projectors (`_unfreeze_PETF`,
    `modeling_OmniAVSR.py:234-260`; projectors are never frozen), the JAX
    package's default split (`omni_avsr_tpu/train/state.py:23-26`)."""
    return ("lora" in path) or ("proj" in path)


def split_params(params: Params, is_trainable: PathPredicate, prefix: str = ""
                 ) -> Tuple[Optional[Params], Optional[Params]]:
    """Split a nested dict into (trainable, frozen) trees by the dotted path
    of each leaf; an empty subtree becomes None."""
    if not isinstance(params, dict):
        return (params, None) if is_trainable(prefix) else (None, params)
    t_out: Params = {}
    f_out: Params = {}
    for k, v in params.items():
        t, f = split_params(v, is_trainable, f"{prefix}.{k}" if prefix else k)
        if t is not None:
            t_out[k] = t
        if f is not None:
            f_out[k] = f
    return (t_out or None), (f_out or None)


def merge_params(trainable: Optional[Params], frozen: Optional[Params]) -> Params:
    """Inverse of split_params."""
    if trainable is None:
        return frozen
    if frozen is None or not isinstance(trainable, dict):
        return trainable
    return {k: merge_params(trainable.get(k), frozen.get(k))
            for k in dict.fromkeys([*trainable, *frozen])}


def tree_map(fn, tree: Params) -> Params:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def tree_leaves(tree: Params):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from tree_leaves(v)
        else:
            yield v


def cast_trainable(trainable: Params, dtype: torch.dtype) -> Params:
    """The masters in the compute dtype, inside the autograd graph."""
    return tree_map(lambda x: x.to(dtype), trainable)


class TrainState(NamedTuple):
    step: int
    trainable: Params  # f32 masters
    opt_state: Any


def master_weights(trainable: Params, device) -> Params:
    """f32 copies of the trainable leaves on `device`, requiring grad."""
    return tree_map(lambda x: x.detach().to(device=device, dtype=torch.float32)
                    .clone().requires_grad_(True), trainable)
