"""Tracing, step timing and NaN hunting (port of
`omni_avsr_tpu/utils/profiling.py`): `trace` records a `torch.profiler`
trace (host and, on the card, CUDA activity) of the steps inside it as a
Chrome trace, `StepTimer` keeps a rolling mean of the host time between
steps, `find_nonfinite` names the leaves of a tensor tree that hold a NaN
or an Inf and `count_nonfinite` counts them on the device; `checkify_step`
runs a step under the float checks of `jax.experimental.checkify`, and
`chain_iteration` threads a loop-carried dependency into a timed loop's
batch.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Iterator, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(profile_dir: Optional[str], device="cuda") -> Iterator[None]:
    """Profile the block into `<profile_dir>/trace_<pid>_<ns>.json`
    (CUDA activity too when `device` is a CUDA device); nothing when
    `profile_dir` is None."""
    if not profile_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir,
                                          f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Rolling mean of the host wall clock between `tick` calls."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: List[float] = []
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        return dt

    @property
    def mean(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0


def find_nonfinite(tree: Any, prefix: str = "") -> List[str]:
    """Dotted paths of the floating leaves that hold a NaN or an Inf."""
    if isinstance(tree, dict):
        bad: List[str] = []
        for k, v in tree.items():
            bad += find_nonfinite(v, f"{prefix}.{k}" if prefix else k)
        return bad
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        if not bool(torch.isfinite(tree.detach()).all()):
            return [prefix]
    return []


def _floating_leaves(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _floating_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _floating_leaves(v)
    elif isinstance(tree, torch.Tensor) and tree.is_floating_point():
        yield tree


def count_nonfinite(tree: Any) -> torch.Tensor:
    """The number of NaN and Inf elements over the floating leaves of a
    nested dict (lists and tuples too) of tensors, as one int32 tensor on
    the leaves' device; nothing is copied to the host. A tree without a
    floating leaf gives an int32 zero."""
    counts = [torch.logical_not(torch.isfinite(x.detach())).sum(dtype=torch.int32)
              for x in _floating_leaves(tree)]
    if not counts:
        return torch.zeros((), dtype=torch.int32)
    return torch.stack(counts).sum(dtype=torch.int32)


# ops that only make, move, select or compare values, and so cannot make a
# NaN of their own: JAX's float checks leave their primitives unchecked
# too (`checkify.nan_primitives` lists the checked ones). The factories
# are left out above all because `empty` returns uninitialised memory.
_UNCHECKED = frozenset("""
    empty empty_like empty_strided new_empty new_empty_strided zeros zeros_like new_zeros
    ones ones_like new_ones full full_like new_full scalar_tensor arange fill zero
    lift_fresh lift_fresh_copy detach alias view _unsafe_view reshape expand expand_as
    permute transpose t squeeze unsqueeze flatten unflatten as_strided contiguous clone
    copy _to_copy to _copy_from _copy_from_and_resize slice select narrow split
    split_with_sizes unbind chunk index index_select gather take_along_dim cat stack
    where masked_fill index_put index_copy scatter maximum minimum clamp clamp_min
    clamp_max max min amax amin neg abs sign sort topk set resize
""".split())

# the divisions JAX lowers to `div_p`, with the position of the divisor
_DIVISIONS = {"div": 1, "true_divide": 1, "floor_divide": 1, "reciprocal": 0}


class FloatChecks(TorchDispatchMode):
    """Under this mode every aten op is checked as `checkify.float_checks`
    checks a JAX primitive: a division whose divisor holds a zero raises
    (`div_p`'s check), and so does an op whose floating output holds a
    NaN, unless the op only makes, moves, selects or compares values
    (`_UNCHECKED`). The error is a `FloatingPointError` that names the
    op. Each check copies one flag to the host: a debug mode."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name.split("::")[-1].rstrip("_")  # in place: as the op
        where = _DIVISIONS.get(name)
        if where is not None and len(args) > where:
            d = args[where]
            zero = bool((d == 0).any()) if isinstance(d, torch.Tensor) else d == 0
            if zero:
                raise FloatingPointError(f"division by zero in op: {func}")
        out = func(*args, **kwargs)
        if name not in _UNCHECKED:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.is_floating_point() \
                        and bool(torch.isnan(t).any()):
                    raise FloatingPointError(f"nan generated by op: {func}")
        return out


def checkify_step(step_fn: Callable) -> Callable:
    """`step_fn` under `FloatChecks`, the counterpart of
    `checkify.checkify(step_fn, errors=checkify.float_checks)` followed by
    `err.throw()`: a step that makes a NaN or divides by zero raises
    `FloatingPointError` naming the first op that did; otherwise the
    wrapped step returns exactly what `step_fn` returns (the mode only
    reads each op's output). The autograd engine carries the mode into a
    backward inside the step."""

    def wrapped(*args, **kwargs):
        with FloatChecks():
            return step_fn(*args, **kwargs)

    return wrapped


def chain_iteration(batch: dict, acc, key: str = "audio") -> dict:
    """A copy of `batch` whose `key` input carries `acc * 1e-38`, so that a
    timed loop's iterations depend on each other and none can be left
    out. `acc` and 1e-38 are cast to the input's dtype first, as the JAX
    package casts them: against inputs of order 0.1 the sum is the input
    itself, bit for bit, but it is not provably zero, as a multiply by 0
    would be."""
    b = dict(batch)
    x = b[key]
    a = torch.as_tensor(acc, device=x.device).to(x.dtype)
    b[key] = x + a * torch.tensor(1e-38, dtype=x.dtype, device=x.device)
    return b
