"""Pipeline parallelism (GPipe schedule) over the stacked LLM decoder (port
of `omni_avsr_tpu/parallel/pipeline.py`).

The stacked-layer tree's leading axis is sharded over the pp mesh axis:
stage s holds layers [s*L/S, (s+1)*L/S). With M microbatches and S stages
the schedule runs M + S - 1 ticks; at tick t stage s runs microbatch
t - s. Activations go stage to stage with point-to-point messages inside
autograd Functions: a forward send's backward receives the gradient, and a
forward receive's backward sends it back. No message carries a tag (NCCL
ignores tags, and every microbatch's message has the same shape), so both
ends of a link keep one fixed order: the forward's messages in tick order,
the backward's by call, then microbatch from last to first. The autograd
engine may reach the microbatches' backward nodes in another order, and
not in the same one on neighbouring stages: a receive's backward therefore
holds each gradient until those before it in that order have gone, and a
send's backward receives in that order up to the one it needs and keeps
the rest (`_Link`). Each stage holds the whole (replicated) input, so the
rope positions of a microbatch are read locally rather than sent.

The last stage's outputs are broadcast to the pp group, as the JAX
package's `psum`-masked broadcast does; the broadcast's backward hands the
last stage its own cotangent, once (every stage computes the same one).
The layer gradients are then exactly the unpipelined backbone's. Of the
replicated parameters, those before the stack (embedding, projectors,
towers) get a gradient on stage 0 only and those after it (final norm,
lm_head) the same one on every stage, so stage 0 holds the whole
gradient of every replicated leaf: the engine broadcasts it over pp
(`train/engine.py`), and sums nothing.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..config import LLMConfig
from .mesh import AXIS_PP, Axis, axis

Params = Any

_PENDING: List[Any] = []  # (work, buffer) of the sends in flight
# the leaves that carry the receives' backward: autograd runs a node's
# backward only on a path to an input it is asked for, so the step asks
# for these too (`anchors`)
_ANCHORS: List[torch.Tensor] = []


class _Link:
    """The backward's messages of one stage to one neighbour, in the fixed
    order (call, then microbatch from last to first) of the pipeline calls
    made with grad since the last `drain`."""

    def __init__(self):
        self.order: List[Tuple[int, int]] = []  # (call, microbatch) in message order
        self.meta: Dict[Tuple[int, int], Any] = {}  # -> (shape, dtype, peer, group)
        self.done = 0  # messages of `order` sent or received so far
        self.held: Dict[Tuple[int, int], torch.Tensor] = {}

    def add_call(self, call: int, M: int, meta) -> None:
        for m in reversed(range(M)):
            self.order.append((call, m))
            self.meta[(call, m)] = meta

    def send(self, key, g: torch.Tensor) -> None:
        """Hold `g`, then send every held gradient whose turn has come."""
        self.held[key] = g.contiguous()
        while self.done < len(self.order) and self.order[self.done] in self.held:
            buf = self.held.pop(self.order[self.done])
            _, _, peer, group = self.meta[self.order[self.done]]
            _PENDING.append((dist.isend(buf, peer, group=group), buf))
            self.done += 1

    def recv(self, key, device) -> torch.Tensor:
        """The gradient of `key`: received in order up to it, the ones
        before it kept for their own backward."""
        while key not in self.held:
            k = self.order[self.done]
            shape, dtype, peer, group = self.meta[k]
            buf = torch.empty(shape, dtype=dtype, device=device)
            dist.recv(buf, peer, group=group)
            self.held[k] = buf
            self.done += 1
        return self.held.pop(key)

    def finished(self) -> bool:
        return self.done == len(self.order) and not self.held


_TO_NEXT, _TO_PREV = _Link(), _Link()  # gradients from stage s+1, to stage s-1
_CALLS = itertools.count()  # pipeline calls with grad since the last `drain`


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """Static pipeline configuration threaded into the training forward
    (`models/llm.py::llm_backbone(pipeline=...)`), built by
    `cli/common.py::setup_parallelism` from `--mesh-pp` /
    `--pp-microbatches`."""

    mesh: Any
    num_microbatches: int = 4
    axis: str = AXIS_PP
    dp_axis: Optional[str] = None


def pipeline_layer_specs(layers: Params, axis: str = AXIS_PP) -> Params:
    """Spec tree of a stacked-layer tree: the leading (layer) axis over pp."""
    if isinstance(layers, dict):
        return {k: pipeline_layer_specs(v, axis) for k, v in layers.items()}
    return (axis,) + (None,) * (layers.dim() - 1)


def shard_layers(mesh, layers: Params, axis_name: str = AXIS_PP) -> Params:
    """This stage's layers of a stacked-layer tree."""
    from .partitioning import shard_params

    leaves = _leaves(layers)
    S = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))).get(axis_name, 1)
    if leaves[0].shape[0] % S:
        raise ValueError(f"{leaves[0].shape[0]} layers not divisible by pp={S}")
    return shard_params(mesh, layers, pipeline_layer_specs(layers, axis_name))


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _peer(ax: Axis, stage: int) -> int:
    return dist.get_global_rank(ax.group, stage)


class _Send(torch.autograd.Function):
    """Forward: send x to `dst`; returns a scalar that ties the send into
    the graph. Backward: x's gradient from `dst` (`_TO_NEXT`)."""

    @staticmethod
    def forward(ctx, x, dst, key, group):
        ctx.key = key
        buf = x.detach().contiguous()
        _PENDING.append((dist.isend(buf, dst, group=group), buf))
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, g):
        return _TO_NEXT.recv(ctx.key, g.device), None, None, None


class _Recv(torch.autograd.Function):
    """Forward: receive a tensor from `src` (`anchor` only carries the
    backward). Backward: the gradient back to `src` (`_TO_PREV`)."""

    @staticmethod
    def forward(ctx, anchor, shape, dtype, src, key, group):
        ctx.key = key
        out = torch.empty(shape, dtype=dtype, device=anchor.device)
        dist.recv(out, src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        _TO_PREV.send(ctx.key, g)
        return None, None, None, None, None, None


class _Broadcast(torch.autograd.Function):
    """Forward: the last stage's `y` to every stage (the other stages pass
    `dep`, the sum of their sends' ties, and receive). Backward: the last
    stage takes its own cotangent for `y`; the others return a zero for
    `dep`, which runs their sends' backward."""

    @staticmethod
    def forward(ctx, y, shape, dtype, src, last, group):
        ctx.last = last
        out = (y.detach().clone() if last
               else torch.empty(shape, dtype=dtype, device=y.device))
        dist.broadcast(out, src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else g.new_zeros(())), None, None, None, None, None


def anchors() -> List[torch.Tensor]:
    """The receives' anchors of the pipeline calls since the last `drain`:
    pass them to `torch.autograd.grad` beside the parameters."""
    return list(_ANCHORS)


def drain() -> None:
    """Wait for the sends that the last backward left in flight, and start
    the next step's message order afresh."""
    global _TO_NEXT, _TO_PREV, _CALLS
    while _PENDING:
        work, _ = _PENDING.pop()
        work.wait()
    if not (_TO_NEXT.finished() and _TO_PREV.finished()):
        raise RuntimeError("pipeline backward incomplete: a stage's gradient messages were "
                           "not all exchanged before drain()")
    _ANCHORS.clear()
    _TO_NEXT, _TO_PREV, _CALLS = _Link(), _Link(), itertools.count()


def pipeline_backbone(
    mesh,
    layers: Params,
    cfg: LLMConfig,
    inputs_embeds: torch.Tensor,  # (B, T, H) this dp rank's rows
    positions: Optional[torch.Tensor] = None,  # (B, T)
    modality: Optional[str] = None,
    num_microbatches: int = 4,
    remat: str = "dots",
    axis_name: str = AXIS_PP,
    dp_axis: Optional[str] = None,
) -> torch.Tensor:
    """GPipe forward over this stage's layers (`layers`, the stage's slice of
    the stacked tree); returns the final hidden states before the final
    norm, the same layer math as `models/llm.py::llm_backbone` (the causal
    route), on every stage."""
    from ..models.llm import run_layers

    ax = axis(mesh, axis_name)
    S = max(ax.size, 1)
    dp = axis(mesh, dp_axis) if dp_axis else axis(mesh, "dp")
    B, T, H = inputs_embeds.shape
    M = num_microbatches
    if (B * dp.size) % M:
        raise ValueError(f"batch {B * dp.size} not divisible by {M} microbatches")
    if B % M:
        raise ValueError(f"batch {B * dp.size} in {M} microbatches: a microbatch's "
                         f"{B * dp.size // M} rows do not divide dp={dp.size}")
    if cfg.num_layers % S:
        raise ValueError(f"{cfg.num_layers} layers not divisible by pp={S}")
    if positions is None:
        positions = torch.arange(T, device=inputs_embeds.device)[None].expand(B, T)
    x_mb = inputs_embeds.chunk(M, dim=0)
    pos_mb = positions.chunk(M, dim=0)
    if S == 1:
        return torch.cat([run_layers(layers, cfg, x, p, modality, remat)
                          for x, p in zip(x_mb, pos_mb)], dim=0)

    s = ax.rank
    grad = torch.is_grad_enabled()
    call = next(_CALLS) if grad else -1
    mb_shape = x_mb[0].shape
    if grad and s > 0:
        _TO_PREV.add_call(call, M, (mb_shape, inputs_embeds.dtype, _peer(ax, s - 1), ax.group))
    if grad and s < S - 1:
        _TO_NEXT.add_call(call, M, (mb_shape, inputs_embeds.dtype, _peer(ax, s + 1), ax.group))
    anchor = inputs_embeds.new_zeros((), requires_grad=grad)
    if grad and s > 0:
        _ANCHORS.append(anchor)
    outputs, ties = [None] * M, []
    for t in range(M + S - 1):
        m = t - s
        if not 0 <= m < M:
            continue
        if s == 0:
            inp = x_mb[m]
        else:
            inp = _Recv.apply(anchor, mb_shape, inputs_embeds.dtype, _peer(ax, s - 1),
                              (call, m), ax.group)
        out = run_layers(layers, cfg, inp, pos_mb[m], modality, remat)
        if s < S - 1:
            ties.append(_Send.apply(out, _peer(ax, s + 1), (call, m), ax.group))
        else:
            outputs[m] = out
    last = s == S - 1
    y = torch.cat(outputs, dim=0) if last else torch.stack(ties).sum()
    out = _Broadcast.apply(y, (B, T, H), inputs_embeds.dtype, _peer(ax, S - 1), last, ax.group)
    while _PENDING:  # the forward's sends: the next stage has received them
        work, _ = _PENDING.pop()
        work.wait()
    return out
