"""Balanced top-1 routing of the MoE decoder: the greedy of
`omni_avsr_tpu/models/moe.py::_topk_balanced_assignment`, as a kernel.

The tokens are visited in the stable descending order of their best
router score (`jnp.argsort(-scores.max(axis=1))`); each takes the first
expert of the highest score among those whose load is below `capacity`
(full experts masked to -inf), and -1 when none is left. Every token's
choice depends on the loads before it, so the JAX package scans the
tokens in order (`lax.scan`). In eager PyTorch that scan is several
launches per token; `balanced_assignment` runs it in one launch of the
hand-written kernel in `csrc/moe_route.cu` (a CUDA tensor) or takes the
plain loop beside it (a CPU tensor). It replaces no TPU kernel. The
assignments are integers: kernel and plain version are bit-equal.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels import check, load

MAX_EXPERTS = 1024  # the kernel keeps the loads in registers, 32 a lane


def visiting_order(scores: torch.Tensor) -> torch.Tensor:
    """The tokens' order of the greedy: a stable argsort of -max score
    (adding 0.0 makes a -0.0 key +0.0, as JAX's sort treats them equal)."""
    return torch.argsort(-scores.amax(dim=1) + 0.0, stable=True)


def balanced_assignment_plain(scores: torch.Tensor, capacity: int) -> torch.Tensor:
    """(N, E) f32 scores -> (N,) int32 expert per token, -1 where every
    expert was full: the JAX scan's body, token by token."""
    N, E = scores.shape
    order = visiting_order(scores)
    load_ = torch.zeros(E, dtype=torch.int32, device=scores.device)
    assign = torch.full((N,), -1, dtype=torch.int32, device=scores.device)
    inf = torch.tensor(float("inf"), device=scores.device)
    for tok in order.tolist():
        s = scores[tok] - torch.where(load_ >= capacity, inf, 0.0)
        e = int(torch.argmax(s))
        if bool(s[e] > -inf):
            load_[e] += 1
            assign[tok] = e
    return assign


@functools.lru_cache(maxsize=1)
def _launcher():
    """The kernel's C entry point, built and typed once per process."""
    fn = load("moe_route").balanced_route_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(scores: torch.Tensor, capacity: int) -> torch.Tensor:
    N, E = scores.shape
    if E > MAX_EXPERTS:
        raise ValueError(f"{E} experts: the routing kernel takes at most {MAX_EXPERTS}")
    check("scores", scores, (N, E), torch.float32)
    dev = scores.device
    assign = torch.empty((N,), dtype=torch.int32, device=dev)
    if N == 0:
        return assign
    order = visiting_order(scores)
    with torch.cuda.device(dev):
        rc = _launcher()(scores.data_ptr(), order.data_ptr(), assign.data_ptr(), N, E, capacity,
                         torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_route kernel launch failed: CUDA error {rc}")
    balanced_assignment.launches += 1
    return assign


def balanced_assignment(scores: torch.Tensor, capacity: int) -> torch.Tensor:
    """(N, E) f32 router scores -> (N,) int32 expert per token (-1: none
    left), the balanced greedy with `capacity` tokens per expert. CPU
    tensors take the plain loop; CUDA tensors (f32, contiguous) launch the
    kernel and count the launch in `balanced_assignment.launches`."""
    if scores.dim() != 2:
        raise ValueError(f"balanced_assignment: scores of shape {tuple(scores.shape)}, "
                         f"needs (N, E)")
    if scores.device.type == "cpu":
        return balanced_assignment_plain(scores, capacity)
    return _launch(scores, capacity)


balanced_assignment.launches = 0
