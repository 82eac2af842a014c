"""Training the MoE decoder: the port against the JAX package at the tiny
flagship widths with 4 experts (balanced routing), f32 on both sides
(tests/torch_parity.py::jax_in_f32):

  - the three task losses of `train_losses(train_mode=False)` and the
    grads of every trainable leaf of their mean, on the unfused route and
    on the fused three-task route (`fused_task_forward=True`, the tasks
    stacked on the batch axis, whose rows the MoE routes together), at the
    towers' atol 2e-4 / rtol 1e-3. The experts are frozen, as the JAX
    trainable set has them (only LoRA and the projectors train), so the
    grads that reach the trainable leaves have passed through them.

The weights are drawn by the port's `init_params` (its tree's paths and
shapes held equal to the JAX `init_params`' by `jax.eval_shape`), and the
JAX step takes the weights and the batch as arguments: compiling the JAX
init, or folding a batch closed over as constants, would take most of the
file's time.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omni_avsr_tpu_torch.bridge import split_trainable
from omni_avsr_tpu_torch.train.state import cast_trainable, master_weights, merge_params
from tests.test_torch_train import _flat, _grads, _raw_batch, _trim
from tests.torch_parity import jax_in_f32, jax_moe_flagship, port_model, randomize_lora_down


def _drawn_params(jm):
    """numpy f32 weights of the JAX model's tree, drawn by the port, LoRA
    downs randomised."""
    from omni_avsr_tpu_torch.bridge import init_params

    drawn = init_params(port_model(jm).cfg, torch.Generator().manual_seed(0), "cpu",
                        frozen_dtype=torch.float32)
    params = jax.tree_util.tree_map(lambda t: t.numpy(), drawn)
    want = jax.eval_shape(lambda k: jm.init_params(k, frozen_dtype=jnp.float32),
                          jax.random.PRNGKey(0))
    assert (jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    return randomize_lora_down(params)


@pytest.fixture(scope="module")
def tiny():
    from omni_avsr_tpu.ops.augment import audio_pipeline, video_pipeline

    jm = jax_moe_flagship()
    params = _drawn_params(jm)
    raw = _raw_batch(jm.tok)
    proc = dict(raw)
    proc["video"] = np.asarray(video_pipeline(None, raw["video"], raw["video_len"], train=False))
    proc["audio"] = np.asarray(audio_pipeline(None, raw["audio"], raw["audio_len"], train=False))
    return jm, params, proc


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_moe_losses_and_grads_match_jax(monkeypatch, tiny, fused):
    from omni_avsr_tpu.models.omni import OmniAVSR
    from omni_avsr_tpu.train.state import merge_params as jmerge
    from omni_avsr_tpu.train.state import split_params as jsplit

    jax_in_f32(monkeypatch)
    jm, params, proc = tiny
    jm = OmniAVSR(dataclasses.replace(jm.cfg, fused_task_forward=fused), jm.tok)
    trim = _trim()
    jt, jf = jsplit(jax.tree_util.tree_map(jnp.asarray, params), jm.trainable_predicate())

    def jloss(t, f, batch):
        losses = jm.train_losses(jmerge(t, f), batch, 4, 2, trim, train_mode=False)
        return (losses["audio"] + losses["video"] + losses["audiovisual"]) / 3.0, losses

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jt, jf, {k: jnp.asarray(v) for k, v in proc.items()})

    pm = port_model(jm)
    assert pm.cfg.llm.moe_experts == 4 and pm.cfg.fused_task_forward == fused
    trainable, frozen = split_trainable(params, pm.trainable_predicate(), "cpu",
                                        frozen_dtype=torch.float32)
    assert "moe" in frozen["llm"]["layers"]  # the experts are frozen, as in JAX
    masters = master_weights(trainable, "cpu")
    merged = merge_params(cast_trainable(masters, pm.dtype), frozen)
    tproc = {k: torch.from_numpy(np.array(v)) for k, v in proc.items()}
    losses = pm.train_losses(merged, tproc, 4, 2, trim, train_mode=False)
    ((losses["audio"] + losses["video"] + losses["audiovisual"]) / 3.0).backward()
    for m in ("audio", "video", "audiovisual"):
        np.testing.assert_allclose(losses[m].item(), float(jlosses[m]), atol=2e-4, rtol=1e-3)
    want = _flat(jax.device_get(jgrads))
    got = _flat(_grads(masters))
    assert got.keys() == want.keys()
    assert any(".lora.audio." in k for k in got)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=2e-4, rtol=1e-3, err_msg=path)

