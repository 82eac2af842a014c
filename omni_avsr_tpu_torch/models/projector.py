"""Encoder -> LLM projectors with matryoshka per-rate variants (port of
`omni_avsr_tpu/models/projector.py`; reference `modeling_OmniAVSR.py:65-196`):
Linear -> ReLU -> Linear [-> LayerNorm]. Per-rate projectors carry no
LayerNorm (the reference's LN-as-bias quirk)."""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.norms import layer_norm
from .common import Params, linear


def apply_projector(params: Params, x: torch.Tensor) -> torch.Tensor:
    y = linear(torch.relu(linear(x, params["fc1"])), params["fc2"])
    if "ln" in params:
        y = layer_norm(y, params["ln"]["scale"], params["ln"]["bias"])
    return y


def project(params: Params, x: torch.Tensor, rate: Optional[int] = None) -> torch.Tensor:
    if "single" in params:
        return apply_projector(params["single"], x)
    assert rate is not None
    return apply_projector(params["per_rate"][f"r{rate}"], x)
