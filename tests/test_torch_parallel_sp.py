"""Sequence parallelism of the port's decoder (`models/llm.py::run_layers`
under `Parallel(sequence_parallel=True)`) with the blocks that run
replicated over tp (an MoE FFN, an attention whose kv heads do not divide
by tp, an MLP whose width does not) against the same step without SP, the
port's one-process step and the JAX engine's step on a (dp=2, tp=2) mesh
under OMNI_SP=1, at the tiny flagship widths in f32; and the pieces of
`run_layers` that SP changes: the flash gate on the unpadded T, an explicit
mask padded to the padded T, the MoE routing only the real positions.

The port's ranks run in gloo `RankPool`s of two and four ranks, one of each
for the file (tests/test_torch_parallel.py's set-up). Criteria: train steps
as tests/test_torch_parallel.py's `_close` (losses rtol 1e-5, the trainable
tree after the step atol 1e-5 / rtol 1e-4); `llm_logits` as
tests/test_torch_llm_loss.py (atol 2e-4 / rtol 1e-3 against JAX), its
input gradient atol 1e-5 / rtol 1e-4 against the port's one-process one.
The global batch's three decoder sequences (23, 17 and 25 positions) divide
neither 2 nor 4, so every step pads T.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_parallel_ranks as R
from tests.test_torch_parallel import _close, _jax_mesh, _no_check, global_batch
from tests.torch_parity import jax_in_f32, jax_moe_flagship, jax_tiny_params

MOE = 4  # experts a layer of the tiny MoE decoder


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    from omni_avsr_tpu_torch.parallel.launch import RankPool

    p = RankPool(2, str(tmp_path_factory.mktemp("rdzv2")), timeout_s=60)
    yield p
    p.close()


@pytest.fixture(scope="module")
def pool4(tmp_path_factory):
    from omni_avsr_tpu_torch.parallel.launch import RankPool

    p = RankPool(4, str(tmp_path_factory.mktemp("rdzv4")), timeout_s=60)
    yield p
    p.close()


@pytest.fixture(scope="module")
def moe():
    """The tiny JAX MoE flagship and its numpy f32 tree (the routing does
    not change the tree)."""
    jm = jax_moe_flagship("balanced", MOE)
    return jm, jax.tree_util.tree_map(np.asarray, jax_tiny_params(jm))


@pytest.fixture(scope="module")
def moe_one_process(moe):
    jm, params = moe
    batch = global_batch(jm.tok)
    return {routing: R.one_process_steps(params, batch, moe_experts=MOE, augment=False,
                                         model=dict(routing=routing))
            for routing in ("balanced", "top1")}


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("routing", ["balanced", "top1"])
def test_moe_sp_tp2_matches_no_sp_and_one_process(pool, moe, moe_one_process, routing):
    jm, params = moe
    batch = global_batch(jm.tok)
    kw = dict(moe_experts=MOE, augment=False, model=dict(routing=routing))
    want = pool.run(R.train_steps, params, batch, dict(dp=1, tp=2), **kw)[0]
    got = pool.run(R.train_steps, params, batch, dict(dp=1, tp=2), sequence_parallel=True,
                   **kw)[0]
    _close(got, want)
    _close(got, moe_one_process[routing])


def test_moe_sp_dp2_tp2_matches_jax_mesh_step(pool4, moe, moe_one_process):
    """dp 2 x tp 2 with SP: the MoE gathers over T and then over dp, and
    routes the global batch's tokens in the global (B, T) order, as the
    JAX step does under OMNI_SP=1 on its (dp=2, tp=2) mesh."""
    import omni_avsr_tpu.train.state as jstate
    from omni_avsr_tpu.config import TrainConfig as JaxTrainConfig
    from omni_avsr_tpu.parallel.distributed import global_batch_from_local
    from omni_avsr_tpu.parallel.partitioning import (clamp_specs_to_shapes,
                                                     llm_partition_specs, shard_params)
    from omni_avsr_tpu.train.engine import OmniEngine as JaxEngine

    jm, params = moe
    batch = global_batch(jm.tok)
    with pytest.MonkeyPatch.context() as mp:
        jax_in_f32(mp)
        mp.setattr(jstate.make_train_step, "__defaults__", (jnp.float32,))
        mp.setenv("OMNI_SP", "1")
        mesh = _jax_mesh(dp=2, tp=2)
        tree = jax.tree_util.tree_map(jnp.asarray, params)
        with _no_check():
            specs = clamp_specs_to_shapes(mesh, tree["llm"], llm_partition_specs(tree["llm"]))
        tree["llm"] = shard_params(mesh, tree["llm"], specs)
        je = JaxEngine(jm, tree, JaxTrainConfig(lr=1e-3), augment=False, seed=3)
        arrays = {k: v for k, v in batch.items() if k != "audio_trim_len"}
        with mesh:  # the residual stream's P(dp, tp) constraint names the mesh's axes
            loss = float(je.train_step({**global_batch_from_local(mesh, arrays),
                                        "audio_trim_len": 25}))
        jax_step = ([loss], R.flat(jax.tree_util.tree_map(
            lambda x: torch.from_numpy(np.array(x)), jax.device_get(je.state.trainable))))
    got = pool4.run(R.train_steps, params, batch, dict(dp=2, tp=2), moe_experts=MOE,
                    augment=False, sequence_parallel=True)[0]
    _close(got, jax_step)
    _close(got, moe_one_process["balanced"])


@pytest.fixture(scope="module")
def kv1():
    """The tiny flagship with one kv head (its attention runs replicated at
    tp 2) and a tree of its shapes."""
    from omni_avsr_tpu_torch.bridge import init_params

    pm = R.tiny_model(kv_heads=1)
    return pm, R.numpy_tree(init_params(pm.cfg, torch.Generator().manual_seed(0), "cpu"))


def test_replicated_attention_sp_matches_no_sp_and_one_process(pool, kv1):
    pm, params = kv1
    batch = global_batch(pm.tok)
    kw = dict(augment=False, model=dict(kv_heads=1))
    want = pool.run(R.train_steps, params, batch, dict(dp=1, tp=2), **kw)[0]
    got = pool.run(R.train_steps, params, batch, dict(dp=1, tp=2), sequence_parallel=True,
                   **kw)[0]
    _close(got, want)
    _close(got, R.one_process_steps(params, batch, **kw))


def test_replicated_mlp_sp_matches_one_process(pool4):
    """An FFN width of 254 does not divide by tp 4: the MLP runs replicated,
    the attention (8 / 4 heads) four-way, the stream padded to T % 4 == 0."""
    from omni_avsr_tpu_torch.bridge import init_params

    pm = R.tiny_model(ffn=254)
    params = R.numpy_tree(init_params(pm.cfg, torch.Generator().manual_seed(1), "cpu"))
    batch = global_batch(pm.tok)
    kw = dict(augment=False, model=dict(ffn=254))
    got = pool4.run(R.train_steps, params, batch, dict(dp=1, tp=4), sequence_parallel=True,
                    **kw)[0]
    _close(got, R.one_process_steps(params, batch, **kw))


# ---------------------------------------------------------------------------
# run_layers under SP: the flash gate, an explicit mask, the MoE's real rows
# ---------------------------------------------------------------------------

def test_flash_gate_reads_the_unpadded_length():
    """At T 255 and tp 2 the stream is padded to 256, the gate's threshold;
    the JAX gate sees the global T of 255 and takes the plain attention."""
    from omni_avsr_tpu_torch.models.llm import flash_causal_gate
    from omni_avsr_tpu_torch.ops.attention import FLASH_MIN_T_TRAIN

    assert FLASH_MIN_T_TRAIN == 256
    assert not flash_causal_gate(255, 64, on_card=True)
    assert flash_causal_gate(256, 64, on_card=True)
    assert not flash_causal_gate(256, 16, on_card=True)
    assert not flash_causal_gate(512, 64, on_card=False)


def test_flash_gate_under_sp_at_t255(monkeypatch):
    """`run_layers` at T 255 under a tp-2 SP scope (one process: the
    collectives patched to their one-rank values) asks the gate about 255
    positions, not the 256 it pads to, and gives the plain route a causal
    mask at 256 and each layer its 255 real positions."""
    import omni_avsr_tpu_torch.config as port_cfg
    import omni_avsr_tpu_torch.models.llm as L
    from omni_avsr_tpu_torch.parallel import collectives as par
    from omni_avsr_tpu_torch.parallel.mesh import Axis
    from tests.test_llm import tiny_cfg
    from tests.torch_parity import twin_config

    asked, layers_saw = [], []

    def layer(layer, cfg, x, cos, sin, mask, modality, flash_causal, n_real):
        layers_saw.append((tuple(mask.shape), flash_causal, n_real))
        return x

    monkeypatch.setattr(L, "flash_causal_gate", lambda T, D, on_card: asked.append(T) or False)
    monkeypatch.setattr(par, "sp_axis", lambda: Axis("tp", 2, 0))
    monkeypatch.setattr(par, "scatter", lambda x, ax, dim: x)
    monkeypatch.setattr(par, "gather", lambda x, ax, dim, grad="slice": x)
    monkeypatch.setattr(L, "_decoder_layer", layer)
    cfg = twin_config(tiny_cfg(), port_cfg)
    x = torch.zeros(1, 255, cfg.hidden_size)
    out = L.run_layers({"w": torch.zeros(cfg.num_layers, 1)}, cfg, x, torch.arange(255)[None],
                       remat="off")
    assert asked == [255] and out.shape == x.shape
    assert layers_saw == [((1, 1, 256, 256), False, 255)] * cfg.num_layers


def test_pad_mask():
    from omni_avsr_tpu_torch.models.llm import pad_mask

    m = torch.tril(torch.ones(5, 5, dtype=torch.bool))[None, None].repeat(2, 1, 1, 1)
    m[1, ..., 3:] = False
    p = pad_mask(m, 8)
    assert p.shape == (2, 1, 8, 8) and p.dtype == torch.bool
    assert torch.equal(p[..., :5, :5], m)
    assert not p[..., :5, 5:].any()  # padding keys masked for every real row
    assert torch.equal(p[..., 5:, :], torch.eye(8, dtype=torch.bool)[5:].expand(2, 1, 3, 8))


@pytest.fixture(scope="module")
def small_llm():
    """tests/test_llm.py's tiny LLM (GQA 4/2, every LoRA leaf random) at
    T 11, with a causal padding mask of lengths (11, 8, 5)."""
    import omni_avsr_tpu_torch.config as port_cfg
    from omni_avsr_tpu.models import llm as L
    from tests.test_llm import tiny_cfg
    from tests.torch_parity import twin_config

    cfg = tiny_cfg()
    params = jax.tree_util.tree_map(np.asarray, L.init_llm(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(0)
    for task in params["layers"]["lora"].values():
        for leaf in task.values():
            leaf["w"] = (rng.randn(*leaf["w"].shape) * 0.05).astype(np.float32)
    B, T = 3, 11
    embeds = (rng.randn(B, T, cfg.hidden_size) * 0.5).astype(np.float32)
    key_valid = np.arange(T)[None] < np.array([T, 8, 5])[:, None]
    mask = np.tril(np.ones((T, T), bool))[None, None] & key_valid[:, None, None, :]
    cot = rng.randn(B, T, cfg.vocab_size).astype(np.float32)
    return dict(L=L, cfg=cfg, pcfg=twin_config(cfg, port_cfg), params=params, embeds=embeds,
                mask=mask, cot=cot)


def _one_process_logits(pcfg, params, embeds, mask, cot, modality):
    from omni_avsr_tpu_torch.bridge import params_from_numpy
    from omni_avsr_tpu_torch.models.llm import llm_logits

    x = torch.from_numpy(embeds).requires_grad_(True)
    logits = llm_logits(params_from_numpy(params, "cpu"), pcfg, x,
                        mask=None if mask is None else torch.from_numpy(mask),
                        modality=modality, remat="off")
    (grad,) = torch.autograd.grad((logits * torch.from_numpy(cot)).sum(), x)
    return logits.detach().numpy(), grad.numpy()


@pytest.mark.parametrize("remat", ["off", "dots"])
def test_masked_llm_logits_under_sp(pool, small_llm, remat):
    """`llm_logits` with a padding mask under a tp-2 SP scope: T 11 is padded
    to 12 with `pad_mask`; the logits equal the call without SP and the
    JAX function's, the input gradient the one-process one (finite: no
    padding row is all -inf). The backward runs outside the scope, as on
    the card: under "dots" each layer's recompute must take the scope with
    it (else it runs on this rank's slice of T without the gathers)."""
    s = small_llm
    modality = "audiovisual"
    want = np.asarray(jax.jit(lambda p, e, m: s["L"].llm_logits(
        p, s["cfg"], e, mask=m, modality=modality, remat=False))(
        s["params"], s["embeds"], jnp.asarray(s["mask"])))
    _, want_grad = _one_process_logits(s["pcfg"], s["params"], s["embeds"], s["mask"], s["cot"],
                                       modality)
    args = (s["pcfg"], s["params"], s["embeds"], s["mask"], 2)
    no_sp = pool.run(R.llm_case, *args, False, modality, s["cot"], remat)
    sp = pool.run(R.llm_case, *args, True, modality, s["cot"], remat)
    for (logits, grad, blocks), (ref_logits, _, _) in zip(sp, no_sp):
        assert blocks == ["llm.attn", "llm.mlp"]
        np.testing.assert_allclose(logits, ref_logits, atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(logits, want, atol=2e-4, rtol=1e-3)
        assert np.isfinite(grad).all()
        np.testing.assert_allclose(grad, want_grad, atol=1e-5, rtol=1e-4)


def test_moe_under_sp_routes_the_real_positions_only(pool, small_llm):
    """Top-1 routing with a zero router (every token ties, so all go to
    expert 0, as many as its capacity keeps, in (B, T) order) at B 2 x T 7
    and tp 2: the real positions give N 14 and capacity int(7 * 1.25) = 8,
    so expert 0 keeps row 0 and row 1's first position. Routing the padded
    stream (T 8) would give N 16, capacity 10 and a padding slot before
    row 1: row 1's second position would be kept as well."""
    from omni_avsr_tpu.models import llm as L

    s = small_llm
    cfg = dataclasses.replace(s["cfg"], moe_experts=2, moe_routing="top1")
    params = jax.tree_util.tree_map(np.array, L.init_llm(jax.random.PRNGKey(1), cfg))
    params["layers"]["moe"]["gate"]["w"][:] = 0.0
    pcfg = dataclasses.replace(s["pcfg"], moe_experts=2, moe_routing="top1")
    embeds, cot = s["embeds"][:2, :7], s["cot"][:2, :7]
    want, want_grad = _one_process_logits(pcfg, params, embeds, None, cot, "audio")
    for logits, grad, blocks in pool.run(R.llm_case, pcfg, params, embeds, None, 2, True,
                                         "audio", cot):
        assert "llm.mlp" not in blocks
        np.testing.assert_allclose(logits, want, atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(grad, want_grad, atol=1e-5, rtol=1e-4)
