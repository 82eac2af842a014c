"""The MoE decoder of the port (`models/moe.py`, `ops/moe_route.py`) against
the JAX package's `omni_avsr_tpu/models/moe.py`, f32 on both sides:

  - `moe_ffn` for top-1 and balanced routing, with capacity drops and with
    tied router scores: outputs within rtol/atol 2e-5 (`tests/test_moe.py`'s
    tolerance), loads and the dropped count exactly equal, gradients within
    the same tolerance and reaching every expert;
  - the balanced greedy's assignments exactly equal to
    `_topk_balanced_assignment`, ties and full experts (-1) included;
  - the host auction `balanced_assignment_native` and its numpy twin equal
    to the JAX package's;
  - an MoE decoder (the tiny flagship's LLM, 4 experts): the masked
    prefill's logits within 2e-5, and greedy and beam-15 decodes
    token-identical on the ancestor route (B1's plain version; the JAX
    Pallas kernel in interpret mode) and the reorder route;
  - `bridge.init_params` and `params_from_numpy` carry the MoE tree.
One jitted JAX function per case, the model and prefix shared.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omni_avsr_tpu_torch.bridge import init_params, params_from_numpy
from omni_avsr_tpu_torch.models.moe import moe_ffn
from omni_avsr_tpu_torch.ops.moe_route import balanced_assignment, balanced_assignment_plain
from tests.torch_parity import jax_in_f32, jax_moe_flagship, jax_tiny_params, port_model

N, H, F, E = 24, 16, 32, 4
TOL = dict(rtol=2e-5, atol=2e-5)


def _jax_moe_params(seed: int = 0):
    from omni_avsr_tpu.models.moe import init_moe

    return jax.device_get(init_moe(jax.random.PRNGKey(seed), E, H, F))


def _x(case: str) -> np.ndarray:
    x = np.random.RandomState(1).randn(N, H).astype(np.float32)
    if case == "ties":  # repeated rows: tied best scores, the stable order decides
        x[8:16] = x[0:8]
    return x


def _gate_with_ties(params):
    """Experts 1 and 2 with the same router column: every token's scores
    tie between them, the first index must win."""
    w = np.array(params["gate"]["w"])
    w[:, 2] = w[:, 1]
    return {**params, "gate": {"w": w}}


CASES = {  # name -> (routing, capacity factor, x case, tied router columns)
    "top1": ("top1", 1.25, "plain", False),
    "top1-drop": ("top1", 0.5, "plain", False),
    "top1-ties": ("top1", 1.25, "ties", True),
    "balanced": ("balanced", 1.25, "plain", False),
    "balanced-ties": ("balanced", 1.25, "ties", True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_jax(case):
    from omni_avsr_tpu.models.moe import moe_ffn as jax_moe_ffn

    routing, cf, xcase, tied = CASES[case]
    params = _jax_moe_params()
    if tied:
        params = _gate_with_ties(params)
    x = _x(xcase)
    r = np.random.RandomState(2).randn(N, H).astype(np.float32)

    def jloss(p, xx):
        y, aux = jax_moe_ffn(p, xx, capacity_factor=cf, routing=routing)
        return jnp.sum(y * r), (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))

    tp = params_from_numpy(params, "cpu")
    for leaf in (tp["gate"]["w"], *(v["w"] for v in tp["experts"].values())):
        leaf.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe_ffn(tp, tx, cf, routing)
    aux = {k: v.detach() for k, v in aux.items()}
    (y * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(aux["loads"].numpy(), np.asarray(jaux["loads"]))
    assert float(aux["dropped"]) == float(jaux["dropped"])
    np.testing.assert_allclose(aux["aux_loss"].item(), float(jaux["aux_loss"]), **TOL)
    if case == "top1-drop":
        assert float(aux["dropped"]) > 0
    if routing == "balanced":
        assert float(aux["dropped"]) == 0 and aux["loads"].max() - aux["loads"].min() <= 1
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    np.testing.assert_allclose(tp["gate"]["w"].grad.numpy(), np.asarray(jgp["gate"]["w"]), **TOL)
    for name, leaf in tp["experts"].items():
        g = leaf["w"].grad
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp["experts"][name]["w"]), **TOL)
        for e in range(E):  # every expert that took a token gets a gradient
            assert (g[e].abs().sum() > 0) == bool(aux["loads"][e] > 0), (name, e)
    if tied and routing == "top1":  # experts 1 and 2 tie on every token: 1 wins
        assert aux["loads"][2] == 0 and aux["loads"][1] > 0
    else:  # every expert took tokens, so the gradient reached every expert
        assert (aux["loads"] > 0).all()


@pytest.mark.parametrize("capacity", [6, 5, 3])
@pytest.mark.parametrize("ties", [False, True])
def test_balanced_assignment_matches_jax(capacity, ties):
    """The greedy's assignments, bit for bit: capacity ceil(N / E) (6),
    and smaller ones where experts fill up and tokens get -1."""
    from omni_avsr_tpu.models.moe import _topk_balanced_assignment

    rng = np.random.RandomState(3)
    scores = rng.randn(N, E).astype(np.float32)
    if ties:  # tied best scores across tokens, and tied experts within tokens
        scores[5] = scores[2]
        scores[9] = scores[2]
        scores[:, 3] = scores[:, 0]
        scores[11] = 0.0
    want = np.asarray(jax.jit(_topk_balanced_assignment, static_argnums=1)(
        jnp.asarray(scores), capacity))
    got = balanced_assignment(torch.from_numpy(scores), capacity).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    if capacity * E < N:
        assert (got == -1).sum() == N - capacity * E
    np.testing.assert_array_equal(balanced_assignment_plain(torch.from_numpy(scores),
                                                            capacity).numpy(), want)


@pytest.mark.parametrize("shape", [(32, 4), (48, 8), (8, 8)])
def test_native_balanced_assignment_matches_jax(shape):
    from omni_avsr_tpu.utils.native import _balanced_assignment_py as jax_py
    from omni_avsr_tpu.utils.native import balanced_assignment_native as jax_native

    from omni_avsr_tpu_torch.utils.native import (balanced_assignment_native,
                                                  balanced_assignment_py)

    scores = np.random.RandomState(shape[0]).randn(*shape).astype(np.float32)
    want = jax_native(scores)
    got = balanced_assignment_native(scores)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(balanced_assignment_py(scores), jax_py(scores))
    k = shape[0] // shape[1]  # every worker takes k distinct jobs
    assert sorted(got.tolist()) == list(range(shape[0])) and len(got) == k * shape[1]
    with pytest.raises(ValueError, match="do not divide"):
        balanced_assignment_native(scores[:-1])


# ---------------------------------------------------------------------------
# the MoE decoder
# ---------------------------------------------------------------------------

B, P, K, MAX_NEW = 3, 16, 15, 8


@pytest.fixture(scope="module")
def decoder():
    jm = jax_moe_flagship()
    params = jax_tiny_params(jm)
    rng = np.random.RandomState(11)
    emb = (rng.randn(B, P, jm.cfg.llm.hidden_size) * 0.5).astype(np.float32)
    valid = rng.rand(B, P) < 0.75
    valid[:, 0] = True
    return dict(jm=jm, pm=port_model(jm), params=params, emb=emb, valid=valid,
                jllm=jax.tree_util.tree_map(jnp.asarray, params["llm"]),
                tllm=params_from_numpy(params["llm"], "cpu"))


def test_moe_tree_carried(decoder):
    """`params_from_numpy` carries the JAX MoE tree leaf for leaf, and
    `bridge.init_params` builds the same shapes ("moe" in place of "mlp")."""
    jm, params, tllm = decoder["jm"], decoder["params"], decoder["tllm"]
    layers = params["llm"]["layers"]
    assert "moe" in layers and "mlp" not in layers
    for name in ("gate", "up", "down"):
        np.testing.assert_array_equal(tllm["layers"]["moe"]["experts"][name]["w"].numpy(),
                                      layers["moe"]["experts"][name]["w"])
    ours = init_params(decoder["pm"].cfg, torch.Generator().manual_seed(0), "cpu")

    def shapes(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(shapes(v, f"{prefix}.{k}") if isinstance(v, dict)
                       else {f"{prefix}.{k}": tuple(v.shape)})
        return out

    assert shapes(ours["llm"]) == shapes(params["llm"])


def test_prefill_logits_match_jax(decoder, monkeypatch):
    import omni_avsr_tpu.models.llm as jl

    import omni_avsr_tpu_torch.models.llm as tl

    jax_in_f32(monkeypatch)
    s = decoder
    cfg = s["jm"].cfg.llm
    positions = np.maximum(np.cumsum(s["valid"], axis=1) - 1, 0).astype(np.int32)
    last = (P - 1 - np.argmax(s["valid"][:, ::-1], axis=1)).astype(np.int32)

    def jfn(p, emb, valid, pos, last_idx):
        cache = jl.KVCache.create(cfg, B, P + MAX_NEW, dtype=jnp.float32)
        lg, _ = jl.llm_prefill_masked(p, cfg, emb, valid, pos, last_idx, cache, "audio")
        return lg

    want = np.asarray(jax.jit(jfn)(s["jllm"], jnp.asarray(s["emb"]), jnp.asarray(s["valid"]),
                                   jnp.asarray(positions), jnp.asarray(last)))
    pcfg = s["pm"].cfg.llm
    cache = tl.KVCache.create(pcfg, B, P + MAX_NEW, dtype=torch.float32)
    got, _ = tl.llm_prefill_masked(s["tllm"], pcfg, torch.from_numpy(s["emb"]),
                                   torch.from_numpy(s["valid"]),
                                   torch.from_numpy(positions).long(),
                                   torch.from_numpy(last).long(), cache, "audio")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("route", ["kernel", "xla"], ids=["anc", "reorder"])
@pytest.mark.parametrize("fn_name", ["beam_search", "greedy_decode"])
def test_decode_matches_jax(decoder, monkeypatch, route, fn_name):
    """Beam 15 (B * K = 45 rows routed together each step) and greedy
    decoding over the gap-tolerant prefix, whose pad rows are routed too."""
    import omni_avsr_tpu.decode.decoding as jdec

    import omni_avsr_tpu_torch.decode.decoding as tdec

    jax_in_f32(monkeypatch)
    s = decoder
    tok = s["jm"].tok
    common = dict(max_new=MAX_NEW, eos_id=tok.eos_id, pad_id=tok.pad_id, modality="audio",
                  attn_route=route)
    if fn_name == "beam_search":
        common["num_beams"] = K
    jfn = jax.jit(functools.partial(getattr(jdec, fn_name), cfg=s["jm"].cfg.llm,
                                    cache_dtype=jnp.float32, **common))
    want = np.asarray(jfn(s["jllm"], prefix_embeds=jnp.asarray(s["emb"]),
                          key_valid=jnp.asarray(s["valid"])))
    out = getattr(tdec, fn_name)(s["tllm"], s["pm"].cfg.llm, torch.from_numpy(s["emb"]),
                                 key_valid=torch.from_numpy(s["valid"]),
                                 cache_dtype=torch.float32, **common)
    np.testing.assert_array_equal(out.tokens.numpy(), want)
    assert (want != tok.pad_id).any()
