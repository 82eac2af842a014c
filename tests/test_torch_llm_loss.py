"""The whole-sequence causal-LM forward and loss of the port
(`omni_avsr_tpu_torch/models/llm.py::llm_logits`, `causal_lm_token_stats`,
`causal_lm_loss`, `llm_loss`) against the JAX package's
(`omni_avsr_tpu/models/llm.py:411-497`), on tests/test_llm.py's tiny LLM
(GQA 4/2, task-specific LoRA with every adapter leaf random), in f32, with
one jitted JAX function of each kind shared by the file's cases:

  - `llm_logits` causal and with an explicit padding mask: atol 2e-4 /
    rtol 1e-3 (the towers' tolerance);
  - `causal_lm_token_stats` and `causal_lm_loss` on the same logits,
    including a row whose labels are all -100: rtol 1e-6;
  - `llm_loss` and the grads of every leaf of the task's LoRA adapter
    against `jax.grad` of the JAX loss, with and without remat: rtol 1e-4.

On the CPU the causal stack takes the plain attention; the card's route
(B3 forward, B4 backward at T >= 256) is held against it by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

B, T = 3, 12
MODALITY = "audiovisual"


@pytest.fixture(scope="module")
def setup():
    import omni_avsr_tpu_torch.config as port_cfg
    from omni_avsr_tpu.models import llm as L
    from tests.test_llm import tiny_cfg
    from tests.torch_parity import twin_config

    cfg = tiny_cfg()
    params = jax.tree_util.tree_map(np.asarray, L.init_llm(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(0)
    for task in params["layers"]["lora"].values():  # the ups start at zero: make every leaf live
        for leaf in task.values():
            leaf["w"] = (rng.randn(*leaf["w"].shape) * 0.05).astype(np.float32)
    embeds = (rng.randn(B, T, cfg.hidden_size) * 0.5).astype(np.float32)
    labels = rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels[:, :4] = -100  # the prompt's prefix
    labels[1, 9:] = -100  # right padding
    lengths = np.array([T, 9, 5])
    key_valid = np.arange(T)[None] < lengths[:, None]
    mask = np.tril(np.ones((T, T), bool))[None, None] & key_valid[:, None, None, :]

    logits_fn = jax.jit(lambda p, e, m: L.llm_logits(p, cfg, e, mask=m, modality=MODALITY,
                                                     remat=False))
    return dict(L=L, cfg=cfg, pcfg=twin_config(cfg, port_cfg), params=params, embeds=embeds,
                labels=labels, mask=mask, logits_fn=logits_fn)


def _port(setup):
    from omni_avsr_tpu_torch.bridge import params_from_numpy

    return params_from_numpy(setup["params"], "cpu")


@pytest.mark.parametrize("masked", [False, True])
def test_llm_logits_matches_jax(setup, masked):
    from omni_avsr_tpu_torch.models.llm import llm_logits

    mask = setup["mask"] if masked else None
    want = np.asarray(setup["logits_fn"](setup["params"], setup["embeds"],
                                         None if mask is None else jnp.asarray(mask)))
    with torch.no_grad():
        got = llm_logits(_port(setup), setup["pcfg"], torch.from_numpy(setup["embeds"]),
                         mask=None if mask is None else torch.from_numpy(mask),
                         modality=MODALITY, remat="off")
    assert got.dtype == torch.float32 and got.shape == (B, T, setup["cfg"].vocab_size)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)
    if masked:  # the mask matters: the padded row differs from the causal forward
        causal = np.asarray(setup["logits_fn"](setup["params"], setup["embeds"], None))
        assert np.abs(causal[2, 8] - want[2, 8]).max() > 1e-3  # its keys 5-8 are padding


def test_causal_lm_stats_and_loss_match_jax(setup):
    from omni_avsr_tpu_torch.models.llm import causal_lm_loss, causal_lm_token_stats

    L = setup["L"]
    rng = np.random.RandomState(1)
    logits = (rng.randn(B + 1, T, setup["cfg"].vocab_size) * 3).astype(np.float32)
    labels = np.concatenate([setup["labels"], np.full((1, T), -100, np.int32)])
    jt, jc = L.causal_lm_token_stats(jnp.asarray(logits), jnp.asarray(labels))
    pt, pc = causal_lm_token_stats(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=1e-6)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    assert pc[-1] == 0 and pt[-1] == 0  # the all -100 row adds nothing
    want = float(L.causal_lm_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    # no valid label at all: a zero loss, not a division by zero
    none = np.full_like(labels, -100)
    assert float(causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(none))) == 0.0
    assert float(L.causal_lm_loss(jnp.asarray(logits), jnp.asarray(none))) == 0.0


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("remat", ["off", "dots"])
def test_llm_loss_and_lora_grads_match_jax(setup, remat):
    from omni_avsr_tpu_torch.models.llm import llm_loss

    L, cfg, params = setup["L"], setup["cfg"], setup["params"]

    def jloss(task):  # the task's adapter: the other tasks' take no part
        lora = {**params["layers"]["lora"], MODALITY: task}
        p = {**params, "layers": {**params["layers"], "lora": lora}}
        return L.llm_loss(p, cfg, jnp.asarray(setup["embeds"]), jnp.asarray(setup["labels"]),
                          modality=MODALITY, remat=remat != "off")

    want, wgrads = jax.value_and_grad(jloss)(
        jax.tree_util.tree_map(jnp.asarray, params["layers"]["lora"][MODALITY]))
    port = _port(setup)
    lora = _flat(port["layers"]["lora"][MODALITY])
    for leaf in lora.values():
        leaf.requires_grad_(True)
    loss = llm_loss(port, setup["pcfg"], torch.from_numpy(setup["embeds"]),
                    torch.from_numpy(setup["labels"]).long(), modality=MODALITY, remat=remat)
    grads = torch.autograd.grad(loss, list(lora.values()))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-4)
    wflat = _flat(jax.tree_util.tree_map(np.asarray, wgrads))
    assert wflat.keys() == lora.keys()
    for (name, _), g in zip(lora.items(), grads):
        assert np.abs(wflat[name]).max() > 0, name  # every adapter leaf gets a gradient
        np.testing.assert_allclose(g.numpy(), wflat[name], rtol=1e-4, atol=1e-7, err_msg=name)
