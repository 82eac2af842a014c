"""Mixture-of-Experts SwiGLU FFN of the decoder (port of
`omni_avsr_tpu/models/moe.py`, BASE-layer semantics).

`moe_ffn` routes each row of x (flattened as `x.reshape(-1, H)`, so every
row of one call competes for the same experts) to one expert:
  - "top1": the argmax of the router's softmax, with a per-expert
    capacity of ceil(N / E) * capacity_factor; a token past its expert's
    capacity is dropped (its output is 0: the residual carries it);
  - "balanced": the greedy of `ops/moe_route.py::balanced_assignment` (the
    kernel on the card) with capacity ceil(N / E): equal loads, nothing
    dropped.
The kept token's output is its expert's SwiGLU scaled by its router
probability. The JAX package dispatches through a dense (N, E, C) one-hot
einsum; a one-hot selection is exact, so here the rows are gathered into
their (E, C) slots and the results gathered back, and the experts run as
three batched products (`torch.bmm`), as the JAX package leaves them to
XLA. Returns (y, aux): the GShard load-balancing loss, the per-expert
loads and the dropped count, as the JAX function does.

Expert parallelism (`moe_partition_specs`, the "ep" mesh axis): the batch
shards over dp only, so every ep rank holds the same tokens; each runs
the routing (the same on every rank) and its E/ep experts' slots, and one
all-reduce over ep sums the combine. Inside a data-parallel step the
routing sees the global batch's tokens, as under GSPMD: the rows are
all-gathered over dp first and each rank keeps its own rows of the result.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..ops.moe_route import balanced_assignment
from ..parallel import collectives as par
from ..parallel.mesh import AXIS_EP
from .common import Params

ROUTINGS = ("top1", "balanced")


def init_moe(generator: torch.Generator, num_experts: int, hidden_size: int, ffn_dim: int,
             device="cuda", dtype=torch.float32, lead: Tuple[int, ...] = ()) -> Params:
    """The router gate (H, E) and the stacked experts' gate/up (E, H, F) and
    down (E, F, H), N(0, 1/H) and N(0, 1/F) as the JAX `init_moe` (not the
    same numbers); `lead` stacks them over layers."""

    def normal(shape, std):
        t = torch.empty((*lead, *shape), device=device, dtype=torch.float32)
        t.normal_(0.0, std, generator=generator)
        return t.to(dtype)

    s_in, s_ffn = hidden_size ** -0.5, ffn_dim ** -0.5
    return {
        "gate": {"w": normal((hidden_size, num_experts), s_in)},
        "experts": {
            "gate": {"w": normal((num_experts, hidden_size, ffn_dim), s_in)},
            "up": {"w": normal((num_experts, hidden_size, ffn_dim), s_in)},
            "down": {"w": normal((num_experts, ffn_dim, hidden_size), s_ffn)},
        },
    }


def moe_partition_specs(params: Params) -> Params:
    """Expert weights shard over the ep mesh axis on their leading (expert)
    dim; the router gate replicates (`omni_avsr_tpu/models/moe.py:60-68`)."""
    def experts(x):
        return (AXIS_EP,) + (None,) * (x.dim() - 1)

    return {"gate": {"w": ()},
            "experts": {k: {"w": experts(v["w"])} for k, v in params["experts"].items()}}


def capacity_of(N: int, E: int, capacity_factor: float, routing: str) -> int:
    """Tokens per expert: ceil(N / E) for "balanced", else
    max(1, int(ceil(N / E) * capacity_factor))."""
    per = -(-N // E)
    return per if routing == "balanced" else max(1, int(per * capacity_factor))


def moe_ffn(params: Params, x: torch.Tensor, capacity_factor: float = 1.25,
            routing: str = "top1") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(..., H) -> ((..., H), aux) with aux = {"aux_loss": E * mean((loads /
    N) * mean prob), "loads": (E,) tokens routed to each expert (before
    capacity), "dropped": tokens past capacity}."""
    if routing not in ROUTINGS:
        raise ValueError(f"unknown routing {routing!r}")
    shape = x.shape
    H = shape[-1]
    xt = x.reshape(-1, H)
    dp, ep = par.dp_axis(2), par.ep_axis()
    if dp is not None:  # route the global batch's tokens, as one device does
        n_local = xt.shape[0]
        xt = par.gather(xt, dp, 0, grad="sum")
    N = xt.shape[0]
    wg = params["gate"]["w"]
    E = wg.shape[1]
    C = capacity_of(N, E, capacity_factor, routing)
    logits = torch.matmul(xt, wg.to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    with torch.no_grad():
        if routing == "balanced":
            expert = balanced_assignment(logits.contiguous(), C).long()
        else:
            expert = torch.argmax(probs, dim=-1)
        onehot = (expert[:, None] == torch.arange(E, device=x.device)).to(torch.int64)
        pos = (torch.cumsum(onehot, dim=0) - 1) * onehot  # 0-based slot in its expert
        keep = (pos < C) & (onehot > 0)  # (N, E)
        kept = keep.any(dim=-1)
        # the row's slot in the flat (E * C) dispatch, E * C (a zero row) when dropped
        slot = torch.where(kept, expert * C + pos.sum(dim=-1), E * C)
        src = torch.full((E * C + 1,), N, dtype=torch.int64, device=x.device)
        src.scatter_(0, slot, torch.arange(N, device=x.device))
    gate_val = torch.sum(probs * onehot * kept[:, None], dim=-1)
    ew = params["experts"]
    El = ew["gate"]["w"].shape[0]  # this rank's experts: all, or E/ep
    e0 = ep.rank * El if ep is not None else 0
    if ep is not None:  # each rank's grads are the part its experts give
        xt, gate_val = par.copy_to(xt, ep), par.copy_to(gate_val, ep)
        with torch.no_grad():
            mine = (slot >= e0 * C) & (slot < (e0 + El) * C)
            slot = torch.where(mine, slot - e0 * C, El * C)
    xe = torch.cat([xt, xt.new_zeros(1, H)])[src[e0 * C:(e0 + El) * C]].reshape(El, C, H)
    g = torch.bmm(xe, ew["gate"]["w"].to(xe.dtype))
    u = torch.bmm(xe, ew["up"]["w"].to(xe.dtype))
    ye = torch.bmm(F.silu(g) * u, ew["down"]["w"].to(xe.dtype))
    ye = torch.cat([ye.reshape(El * C, H).float(), ye.new_zeros(1, H, dtype=torch.float32)])
    y = par.reduce_from(ye[slot] * gate_val[:, None], ep).to(x.dtype)
    if dp is not None:
        y = y.narrow(0, dp.rank * n_local, n_local)
    loads = onehot.sum(dim=0).float()
    aux = {"aux_loss": E * torch.mean((loads / N) * probs.mean(dim=0)), "loads": loads,
           "dropped": (N - keep.sum()).float()}
    return y.reshape(shape), aux

