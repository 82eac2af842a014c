"""The single matryoshka projector through the port against the JAX
package, at the tiny flagship widths, on the same numpy parameters, in f32
on both sides (`tests/torch_parity.py::jax_in_f32`):

  - "single-matry": average pooling at every rate into one shared
    projector with its LayerNorm (`is_single_matry_projector`);
  - "single-matry-no-ln": the same without the LayerNorm
    (`remove_layernorm_from_projector`).

For each: `bridge.init_params` makes the JAX initialiser's projectors, the
masked prefix agrees within atol 2e-4 / rtol 1e-3, and beam-15 int8
tokens are identical (`tests/torch_parity.py::check_prefix_and_tokens`).
Stack compression: tests/test_torch_stack.py.
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


@pytest.fixture(scope="module", params=["single-matry", "single-matry-no-ln"])
def variant(request, base_params):
    jm, params = projector_variant(request.param, base_params)
    return request.param, jm, port_model(jm), params


def test_projector_init_matches_jax(variant):
    name, jm, pm, params = variant
    check_projector_init(name, pm, params)


def test_prefix_and_tokens_match_jax(monkeypatch, variant):
    name, jm, pm, params = variant
    check_prefix_and_tokens(monkeypatch, jm, pm, params)
