"""Optimizer and LR schedule (port of `omni_avsr_tpu/train/optim.py`).

Parity targets, written to optax's rules so a step here equals the JAX
package's `optax.chain(clip_by_global_norm, adamw)`:
  - AdamW betas (0.9, 0.98), eps 1e-8, weight decay 0.1 decoupled and
    multiplied by the learning rate, grad clip 10.0
    (`lightning_OmniAVSR.py:152-157`, `train_OmniAVSR.py:327-331`);
  - the global-norm clip g * c / max(||g||, c) (torch's
    `clip_grad_norm_` adds 1e-6 to the norm and would not match);
  - WarmupCosineScheduler: linear warmup over warmup_epochs, then cosine to
    0 over the remaining steps, stepped per optimizer step
    (`utils/cosine.py:6-25`), read at the update count before it is
    incremented, as optax's `scale_by_schedule` does.
The update is made in place on the f32 masters, without autograd.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional

import torch

from ..config import TrainConfig

EPS = 1e-8  # optax.adamw's default


def warmup_cosine_schedule(base_lr: float, warmup_epochs: float, total_epochs: int,
                           steps_per_epoch: float) -> Callable[[int], float]:
    """lr(step) = base * step / warmup_steps                      (step < warmup)
               = base * 0.5 * (1 + cos(pi * (step - warmup) / (total - warmup)))"""
    warmup_steps = warmup_epochs * steps_per_epoch
    total_steps = total_epochs * steps_per_epoch

    def schedule(count: int) -> float:
        if count < warmup_steps:
            lr = count / max(warmup_steps, 1.0)
        else:
            denom = max(total_steps - warmup_steps, 1.0)
            lr = 0.5 * (1.0 + math.cos(math.pi * (count - warmup_steps) / denom))
        return max(lr * base_lr, 0.0)

    return schedule


class AdamWState(NamedTuple):
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        sq_norm: Optional[Callable[[List[torch.Tensor]], torch.Tensor]] = None
                        ) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: g * c / max(||g||_2, c) over all leaves.
    `sq_norm(grads)` gives the squared norm where the leaves are shards of
    the global tree (`train/engine.py`): the sum of every rank's squares,
    each element counted once."""
    if sq_norm is not None:
        norm = torch.sqrt(sq_norm(grads))
    else:
        norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))
    c = torch.tensor(max_norm, dtype=norm.dtype, device=norm.device)
    factor = c / torch.maximum(norm, c)
    return [g * factor for g in grads]


class AdamW:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1, b2,
    eps=1e-8, weight_decay)) over a list of f32 leaves."""

    def __init__(self, cfg: TrainConfig, steps_per_epoch: float):
        self.cfg = cfg
        self.schedule = warmup_cosine_schedule(cfg.lr, cfg.warmup_epochs, cfg.max_epochs,
                                               steps_per_epoch)

    def init(self, params: List[torch.Tensor]) -> AdamWState:
        return AdamWState(0, [torch.zeros_like(p, dtype=torch.float32) for p in params],
                          [torch.zeros_like(p, dtype=torch.float32) for p in params])

    @torch.no_grad()
    def update_(self, params: List[torch.Tensor], grads: List[torch.Tensor],
                state: AdamWState, decay: Optional[List[bool]] = None,
                sq_norm=None) -> AdamWState:
        """One step, in place on `params` and the moments. `decay` is adamw's
        `mask`: the leaves whose weight decay applies (all when None);
        `sq_norm` the clip's squared norm of sharded leaves
        (`clip_by_global_norm`)."""
        b1, b2 = self.cfg.betas
        lr = self.schedule(state.count)
        t = state.count + 1
        decay = [True] * len(params) if decay is None else decay
        for p, g, mu, nu, d in zip(params, clip_by_global_norm(grads, self.cfg.grad_clip, sq_norm),
                                   state.mu, state.nu, decay):
            mu.mul_(b1).add_(g, alpha=1.0 - b1)
            nu.mul_(b2).add_(g * g, alpha=1.0 - b2)
            m_hat = mu / (1.0 - b1 ** t)
            v_hat = nu / (1.0 - b2 ** t)
            update = m_hat / (torch.sqrt(v_hat) + EPS)
            if d:
                update = update + self.cfg.weight_decay * p
            p.sub_(lr * update)
        return AdamWState(t, state.mu, state.nu)


def make_optimizer(cfg: TrainConfig, steps_per_epoch: float):
    """(optimizer, schedule), as the JAX package's `make_optimizer`."""
    opt = AdamW(cfg, steps_per_epoch)
    return opt, opt.schedule


