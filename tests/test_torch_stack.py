"""Stack compression through the port against the JAX package, at the tiny
flagship widths, on the same numpy parameters, in f32 on both sides
(`tests/torch_parity.py::jax_in_f32`):

  - "stack": frame stacking at every matryoshka rate, one projector per
    rate whose input is enc_dim x rate, no LayerNorm;
  - "stack-single-rate": no matryoshka, one rate per modality, one
    projector (input enc_dim x that rate) with its LayerNorm.

For each: `bridge.init_params` makes the JAX initialiser's projectors (the
decision table of `omni_avsr_tpu/models/projector.py:55-101`), the masked
prefix agrees within atol 2e-4 / rtol 1e-3, and beam-15 int8 tokens are
identical (`tests/torch_parity.py::check_prefix_and_tokens`). The single
matryoshka projector: tests/test_torch_single_projector.py.
"""

import pytest

from tests.torch_parity import (
    check_prefix_and_tokens,
    check_projector_init,
    jax_tiny_flagship,
    jax_tiny_params,
    port_model,
    projector_variant,
)


@pytest.fixture(scope="module")
def base_params():
    return jax_tiny_params(jax_tiny_flagship())


@pytest.fixture(scope="module", params=["stack", "stack-single-rate"])
def variant(request, base_params):
    jm, params = projector_variant(request.param, base_params)
    return request.param, jm, port_model(jm), params


def test_projector_init_matches_jax(variant):
    name, jm, pm, params = variant
    check_projector_init(name, pm, params)


def test_prefix_and_tokens_match_jax(monkeypatch, variant):
    name, jm, pm, params = variant
    check_prefix_and_tokens(monkeypatch, jm, pm, params)
