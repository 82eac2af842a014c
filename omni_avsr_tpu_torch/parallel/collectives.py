"""The explicit collectives of the port's parallel step, and the context
that tells the model functions which of them to run.

Under GSPMD the JAX package computes one global batch on one global
parameter tree as if on one device. The port keeps those semantics with
one rank per device and explicit collectives, each in an autograd Function
where a gradient passes through it (the Megatron pairs):

  copy_to       forward identity,    backward all-reduce (before a
                column-split linear: its input's grad is partial per rank);
  reduce_from   forward all-reduce,  backward identity (after a row-split
                linear);
  gather        forward all-gather,  backward the rank's own slice
                ("slice": the consumer runs replicated) or a
                reduce-scatter ("sum": each rank's consumer is its own part
                of the objective: SP, FSDP);
  reduce_scatter forward reduce-scatter, backward all-gather (SP);
  scatter       forward the rank's slice, backward all-gather (SP);
  all_reduce_grad forward all-reduce, backward all-reduce (a statistic of
                the global batch, such as BatchNorm's sums).

Sequence parallelism (`Parallel.sequence_parallel`, over the tp ranks):
the residual stream between decoder layers is each rank's slice of T
(padded to a multiple of tp). A tensor-parallel block gathers its input
over T (`gather`, "sum") and leaves by a reduce-scatter over T. A block
that runs replicated (an attention whose heads do not divide by tp, an MLP
whose leaves do not, every MoE FFN) gathers with "slice", runs the whole
of T on every tp rank and keeps the rank's slice of its output
(`scatter`): each tp rank then holds the whole output gradient and
computes the same whole weight grads, so no reduction over tp is needed
(`models/llm.py::_enter`, `_leave`).

`Parallel` is the context: the mesh's axes as this rank sees them, which
blocks run tensor-parallel, sequence parallelism, and the rows of the
global batch this rank holds (so that every random draw is the global
batch's draw, sliced: `draw_rows`). The engine and `Transcriber` enter it
with `scope(par)`; outside a scope every helper is the identity.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, FrozenSet, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import AXIS_DP, AXIS_EP, AXIS_PP, AXIS_TP, NO_AXIS, Axis, axis


# ---------------------------------------------------------------------------
# raw collectives (no autograd)
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, ax: Axis, op=dist.ReduceOp.SUM) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, op=op, group=ax.group)
    return x


def _all_gather(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x, group=ax.group)
    return torch.cat(parts, dim=dim)


def _own(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    assert n % ax.size == 0, f"dim {dim} of {tuple(x.shape)} not divisible by {ax.size}"
    k = n // ax.size
    return x.narrow(dim, ax.rank * k, k).contiguous()


def _reduce_scatter(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    if dist.get_backend(ax.group) == "nccl":
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((xt.shape[0] // ax.size, *xt.shape[1:]))
        dist.reduce_scatter_tensor(out, xt, group=ax.group)
        return out.movedim(0, dim).contiguous()
    return _own(_all_reduce(x, ax), ax, dim)  # gloo: no reduce-scatter of its own


# ---------------------------------------------------------------------------
# autograd Functions
# ---------------------------------------------------------------------------

class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.ax), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.ax), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim, grad):
        ctx.ax, ctx.dim, ctx.grad = ax, dim, grad
        return _all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "slice":
            return _own(g, ctx.ax, ctx.dim), None, None, None
        return _reduce_scatter(g, ctx.ax, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _reduce_scatter(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.ax, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _own(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.ax, ctx.dim), None, None


def _on(ax: Optional[Axis]) -> bool:
    return ax is not None and ax.active


def copy_to(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    return _Copy.apply(x, ax) if _on(ax) else x


def reduce_from(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    return _Reduce.apply(x, ax) if _on(ax) else x


def all_reduce_grad(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    return _ReduceBoth.apply(x, ax) if _on(ax) else x


def gather(x: torch.Tensor, ax: Optional[Axis], dim: int, grad: str = "slice") -> torch.Tensor:
    if not _on(ax):
        return x
    if not torch.is_grad_enabled() or not x.requires_grad:
        return _all_gather(x, ax, dim)
    return _Gather.apply(x, ax, dim, grad)


def reduce_scatter(x: torch.Tensor, ax: Optional[Axis], dim: int) -> torch.Tensor:
    return _ReduceScatter.apply(x, ax, dim) if _on(ax) else x


def scatter(x: torch.Tensor, ax: Optional[Axis], dim: int) -> torch.Tensor:
    return _Scatter.apply(x, ax, dim) if _on(ax) else x


def all_reduce(x: torch.Tensor, ax: Optional[Axis], op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A detached all-reduce (counts, maxima, reported losses)."""
    return _all_reduce(x.detach(), ax, op) if _on(ax) else x


def all_gather(x: torch.Tensor, ax: Optional[Axis], dim: int) -> torch.Tensor:
    """A detached all-gather along `dim`."""
    return _all_gather(x.detach(), ax, dim) if _on(ax) else x


# ---------------------------------------------------------------------------
# the context
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Parallel:
    """This rank's view of the mesh for one step or one decode."""

    mesh: object = None
    # the blocks that run tensor-parallel, of "llm.attn", "llm.mlp",
    # "llm.lm_head", "whisper.ffn" and "avhubert.ffn": the ones whose leaves
    # all divide by tp (`partitioning.coherent_specs`)
    tp_blocks: FrozenSet[str] = frozenset()
    sequence_parallel: bool = False
    # (first row, global batch) of this rank's rows while a step runs
    rows: Optional[Tuple[int, int]] = None
    # FSDP: the spec tree of the stacked LLM layers (their dp-sharded leaves
    # are all-gathered per layer on use)
    fsdp_layers: Optional[dict] = None
    dp: Axis = NO_AXIS
    tp: Axis = NO_AXIS
    pp: Axis = NO_AXIS
    ep: Axis = NO_AXIS

    @classmethod
    def of(cls, mesh, tp_blocks: Sequence[str] = (), sequence_parallel: bool = False,
           fsdp_layers: Optional[dict] = None) -> "Parallel":
        return cls(mesh, frozenset(tp_blocks), sequence_parallel, None, fsdp_layers,
                   axis(mesh, AXIS_DP), axis(mesh, AXIS_TP), axis(mesh, AXIS_PP),
                   axis(mesh, AXIS_EP))


_CURRENT: contextvars.ContextVar[Optional[Parallel]] = contextvars.ContextVar(
    "omni_parallel", default=None)


def current() -> Optional[Parallel]:
    return _CURRENT.get()


@contextlib.contextmanager
def scope(par: Optional[Parallel]):
    """Run the body under `par` (a no-op for None)."""
    token = _CURRENT.set(par)
    try:
        yield par
    finally:
        _CURRENT.reset(token)


def tp_axis(block: str) -> Optional[Axis]:
    """The tp axis when `block` runs tensor-parallel in the current scope."""
    par = current()
    if par is None or not par.tp.active or block not in par.tp_blocks:
        return None
    return par.tp


def sp_axis() -> Optional[Axis]:
    """The tp axis when the decoder runs sequence-parallel."""
    par = current()
    if par is None or not par.sequence_parallel or par.tp.size < 2:
        return None
    return par.tp


def dp_axis(min_size: int = 1) -> Optional[Axis]:
    """The dp axis of the current scope (None outside one, or when smaller
    than `min_size`: 2 for the computations that an axis of one rank leaves
    as they are without a collective, BatchNorm and MoE routing)."""
    par = current()
    return par.dp if par is not None and par.dp.active and par.dp.size >= min_size else None


def ep_axis() -> Optional[Axis]:
    par = current()
    return par.ep if par is not None and par.ep.active else None


def fsdp_gather(tree, specs, lead: int = 0):
    """Every leaf of `tree` whose spec shards a dim over dp, all-gathered
    over dp on that dim (its gradient reduce-scattered: each rank's is the
    part its rows give); `lead` spec entries are dropped first (1 for a
    layer sliced out of the stacked tree)."""
    dp = dp_axis()
    if dp is None:
        return tree
    if isinstance(tree, dict):
        return {k: fsdp_gather(v, specs[k], lead) for k, v in tree.items()}
    spec = specs[lead:]
    for dim, ax in enumerate(spec):
        if ax == AXIS_DP:
            return gather(tree, dp, dim, grad="sum")
    return tree


def fsdp_layer(layer):
    """A layer of the stacked LLM tree, its FSDP shards gathered."""
    par = current()
    if par is None or par.fsdp_layers is None:
        return layer
    return fsdp_gather(layer, par.fsdp_layers, lead=1)


def reduce_grads(grads: Sequence[torch.Tensor], specs, par: Parallel):
    """A rank's grads -> the global step's, leaf by leaf with its spec: a
    leaf not sharded over pp is broadcast from pipeline stage 0 (which holds
    its whole gradient, `parallel/pipeline.py`), then every leaf not sharded
    over dp is summed over dp (an FSDP leaf's per-layer all-gather has
    reduce-scattered it already); one flat bucket per collective."""
    out = list(grads)

    def bucket(idx, fn):
        if not idx:
            return
        flat = fn(torch.cat([out[i].reshape(-1) for i in idx]))
        o = 0
        for i in idx:
            n = out[i].numel()
            out[i] = flat[o:o + n].view_as(out[i])
            o += n

    if par.pp.active:
        src = dist.get_global_rank(par.pp.group, 0)

        def bcast(flat):
            dist.broadcast(flat, src, group=par.pp.group)
            return flat

        bucket([i for i, s in enumerate(specs) if AXIS_PP not in s], bcast)
    if par.dp.active:
        bucket([i for i, s in enumerate(specs) if AXIS_DP not in s],
               lambda flat: all_reduce(flat, par.dp))
    return out


def global_count(x: torch.Tensor) -> torch.Tensor:
    """A count (or any sum without a gradient) over the global batch."""
    return all_reduce(x, dp_axis())


def batch_stat(x: torch.Tensor) -> torch.Tensor:
    """A sum over this rank's rows -> the sum over the global batch, the
    gradient flowing back to every rank's rows."""
    return all_reduce_grad(x, dp_axis())


def first_row() -> int:
    """This rank's first row in the global batch inside a step over a dp
    slice of it, else 0: a kernel that draws per row (the flash attention's
    hash dropout mask) hashes each row by its index in the global batch, so
    that every rank drops what one process drops for the same rows, as
    `draw_rows` slices the global batch's draws."""
    par = current()
    return par.rows[0] if par is not None and par.rows is not None else 0


def draw_rows(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int]) -> torch.Tensor:
    """`draw(shape)` for a draw whose leading axis is the batch: inside a
    step over a dp slice of the global batch, the global batch's draw,
    sliced to this rank's rows, so that every rank draws what one process
    draws for the whole batch."""
    par = current()
    if par is None or par.rows is None:
        return draw(tuple(shape))
    first, total = par.rows
    full = draw((total, *shape[1:]))
    return full[first:first + shape[0]]
