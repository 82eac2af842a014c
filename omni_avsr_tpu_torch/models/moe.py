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
loads and the dropped count, as the JAX function does. Expert parallelism
(`moe_partition_specs`, the "ep" mesh axis) is not ported (ROADMAP A5).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..ops.moe_route import balanced_assignment
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
    xe = torch.cat([xt, xt.new_zeros(1, H)])[src[:E * C]].reshape(E, C, H)
    ew = params["experts"]
    g = torch.bmm(xe, ew["gate"]["w"].to(xe.dtype))
    u = torch.bmm(xe, ew["up"]["w"].to(xe.dtype))
    ye = torch.bmm(F.silu(g) * u, ew["down"]["w"].to(xe.dtype))
    ye = torch.cat([ye.reshape(E * C, H).float(), ye.new_zeros(1, H, dtype=torch.float32)])
    y = (ye[slot] * gate_val[:, None]).to(x.dtype)
    loads = onehot.sum(dim=0).float()
    aux = {"aux_loss": E * torch.mean((loads / N) * probs.mean(dim=0)), "loads": loads,
           "dropped": (N - keep.sum()).float()}
    return y.reshape(shape), aux

