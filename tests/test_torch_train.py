"""The port's training slice against the JAX package, at the tiny flagship
widths (`__graft_entry__._flagship(tiny=True)`, bucketed Whisper window),
everything in f32 on both sides (tests/torch_parity.py::jax_in_f32):

  - the three task losses of `train_losses(train_mode=False)` (rtol 1e-5)
    and the grads of every trainable leaf of their mean (atol 2e-5 / rtol
    1e-4: f32, sums in other orders through two encoders and the LLM);
  - the ResNet3D frontend in train mode, batch-statistics BN (atol 2e-4 /
    rtol 1e-3, the towers' tolerance of tests/test_audio_tower.py);
  - two `OmniEngine.train_step`s with `augment=False`, the JAX package's
    WER-probe setting: the losses and the trainable tree after the steps.
    The JAX step is built with compute_dtype f32 (`make_train_step`'s
    default is bound when the function is defined, so the test redirects
    that default in this process only; the package is unchanged);
  - the LR schedule, the global-norm clip and AdamW against optax;
  - checkpoints: a round trip, keep-N, and `average_last_n`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omni_avsr_tpu_torch.bridge import params_from_numpy, split_trainable
from omni_avsr_tpu_torch.config import TrainConfig
from omni_avsr_tpu_torch.models.omni import flagship
from omni_avsr_tpu_torch.train.state import (
    TrainState,
    cast_trainable,
    master_weights,
    merge_params,
    tree_leaves,
)
from tests.torch_parity import jax_in_f32, jax_tiny_flagship, jax_tiny_params

B, FRAMES, TOKENS = 2, 8, 6


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(
            v.detach().numpy() if isinstance(v, torch.Tensor) else v)})
    return out


def _raw_batch(tok, seed=0):
    """`__graft_entry__._batch`'s layout: raw 96x96 RGB frames, 16 kHz audio,
    padded token ids and labels with IGNORE_INDEX on the padding."""
    rng = np.random.RandomState(seed)
    ids = tok.encode("hello world test")[:TOKENS]
    ids = ids + [tok.pad_id] * (TOKENS - len(ids))
    labels = [i if i != tok.pad_id else -100 for i in ids]
    S = FRAMES * 640
    return {
        "tokens": np.asarray([ids] * B, np.int32),
        "labels": np.asarray([labels] * B, np.int32),
        "audio": (rng.randn(B, S) * 0.05).astype(np.float32),
        "audio_len": np.asarray([S, S - 700], np.int32),
        "video": rng.randint(0, 255, (B, FRAMES, 96, 96, 3)).astype(np.uint8),
        "video_len": np.asarray([FRAMES, FRAMES - 2], np.int32),
    }


def _trim():
    from omni_avsr_tpu.ops.audio_frontend import whisper_token_len

    return ((int(whisper_token_len(FRAMES * 640)) + 24) // 25) * 25


@pytest.fixture(scope="module")
def tiny():
    jm = jax_tiny_flagship()
    return jm, jax_tiny_params(jm)


def test_losses_and_grads_match_jax(monkeypatch, tiny):
    from omni_avsr_tpu.ops.augment import audio_pipeline, video_pipeline
    from omni_avsr_tpu.train.state import merge_params as jmerge
    from omni_avsr_tpu.train.state import split_params as jsplit

    jax_in_f32(monkeypatch)
    jm, params = tiny
    raw = _raw_batch(jm.tok)
    proc = dict(raw)
    proc["video"] = np.asarray(video_pipeline(None, raw["video"], raw["video_len"], train=False))
    proc["audio"] = np.asarray(audio_pipeline(None, raw["audio"], raw["audio_len"], train=False))
    trim = _trim()
    jt, jf = jsplit(jax.tree_util.tree_map(jnp.asarray, params), jm.trainable_predicate())

    def jloss(t):
        losses = jm.train_losses(jmerge(t, jf), {k: jnp.asarray(v) for k, v in proc.items()},
                                 4, 2, trim, train_mode=False)
        return (losses["audio"] + losses["video"] + losses["audiovisual"]) / 3.0, losses

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jt)

    pm = flagship(tiny=True, dtype=torch.float32, whisper_input_mode="bucket")
    trainable, frozen = split_trainable(params, pm.trainable_predicate(), "cpu",
                                        frozen_dtype=torch.float32)
    masters = master_weights(trainable, "cpu")
    merged = merge_params(cast_trainable(masters, pm.dtype), frozen)
    tproc = {k: torch.from_numpy(np.array(v)) for k, v in proc.items()}
    losses = pm.train_losses(merged, tproc, 4, 2, trim, train_mode=False)
    ((losses["audio"] + losses["video"] + losses["audiovisual"]) / 3.0).backward()
    for m in ("audio", "video", "audiovisual"):
        np.testing.assert_allclose(losses[m].item(), float(jlosses[m]), rtol=1e-5)
    want = _flat(jax.device_get(jgrads))
    got = _flat({k: v for k, v in _grads(masters).items()})
    assert got.keys() == want.keys()
    assert any(k.startswith("avhubert.") for k in got) and any(".lora.audio." in k for k in got)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=2e-5, rtol=1e-4, err_msg=path)


def _grads(tree):
    return {k: _grads(v) if isinstance(v, dict) else
            (v.grad if v.grad is not None else torch.zeros_like(v)) for k, v in tree.items()}


def test_resnet_train_mode_matches_jax(tiny):
    from omni_avsr_tpu.models.resnet3d import resnet3d_forward as jax_resnet

    from omni_avsr_tpu_torch.models.resnet3d import resnet3d_forward

    _, params = tiny
    jp = params["avhubert"]["video_frontend"]
    video = np.random.RandomState(3).randn(2, 5, 88, 88, 1).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, v: jax_resnet(p, v, train_mode=True))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(video)))
    got = resnet3d_forward(params_from_numpy(jp, "cpu"), torch.from_numpy(video), train_mode=True)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)
    eval_out = resnet3d_forward(params_from_numpy(jp, "cpu"), torch.from_numpy(video))
    assert not np.allclose(eval_out.numpy(), want, atol=1e-3)  # batch stats, not running ones


def test_engine_steps_match_jax(monkeypatch, tiny):
    """Two optimizer steps, augment=False, same seed (the same host draws of
    the matryoshka rates): the losses and the f32 trainable tree after the
    steps. An Adam step moves each leaf by about lr = 1e-3 whatever the
    grad's size, so a leaf whose grad is near f32 noise can differ by a
    fraction of a step: atol 1e-5 is 1% of one, while a wrong update is off
    by the whole step."""
    import omni_avsr_tpu.train.state as jstate
    from omni_avsr_tpu.config import TrainConfig as JaxTrainConfig
    from omni_avsr_tpu.train.engine import OmniEngine as JaxEngine

    from omni_avsr_tpu_torch.train.engine import OmniEngine

    jax_in_f32(monkeypatch)
    monkeypatch.setattr(jstate.make_train_step, "__defaults__", (jnp.float32,))
    jm, params = tiny
    raw = _raw_batch(jm.tok, seed=1)
    je = JaxEngine(jm, jax.tree_util.tree_map(jnp.asarray, params), JaxTrainConfig(lr=1e-3),
                   augment=False, seed=3)
    pm = flagship(tiny=True, dtype=torch.float32, whisper_input_mode="bucket")
    pe = OmniEngine(pm, params_from_numpy(params, "cpu"), TrainConfig(lr=1e-3), augment=False,
                    seed=3, device="cpu")
    for step in range(2):
        jloss = float(je.train_step({**raw, "audio_trim_len": _trim()}))
        loss = pe.train_step({**raw, "audio_trim_len": _trim()})
        np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5, err_msg=f"step {step}")
    assert pe.state.step == 2
    want = _flat(jax.device_get(je.state.trainable))
    got = _flat(pe.state.trainable)
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=1e-5, rtol=1e-4, err_msg=path)
    ev_loss, ev_losses = pe.eval_step({**raw, "audio_trim_len": _trim()})
    assert np.isfinite(ev_loss.item()) and set(ev_losses) == {"audio", "video", "audiovisual"}


@pytest.mark.parametrize("warmup", [0.0, 0.5])
def test_schedule_clip_and_adamw_match_optax(warmup):
    import optax

    from omni_avsr_tpu.train.optim import make_optimizer as jax_make_optimizer
    from omni_avsr_tpu.train.optim import warmup_cosine_schedule as jax_schedule

    from omni_avsr_tpu_torch.train.optim import (
        clip_by_global_norm,
        make_optimizer,
        warmup_cosine_schedule,
    )

    ours, ref = warmup_cosine_schedule(1e-3, warmup, 8, 100.0), jax_schedule(1e-3, warmup, 8, 100.0)
    for count in (0, 1, 7, 49, 50, 51, 400, 799, 800, 900):
        # the JAX schedule runs in f32: near the end 1 + cos(...) cancels, so
        # the absolute tolerance is 1e-6 of the base lr
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6, atol=1e-9)

    rng = np.random.RandomState(0)
    for scale in (0.01, 10.0):  # below and above the clip norm of 10
        grads = [rng.randn(7, 5).astype(np.float32) * scale, rng.randn(3).astype(np.float32) * scale]
        want, _ = optax.clip_by_global_norm(10.0).update([jnp.asarray(g) for g in grads], None)
        got = clip_by_global_norm([torch.from_numpy(g) for g in grads], 10.0)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)

    cfg = TrainConfig(lr=1e-3, warmup_epochs=warmup)
    tx, _ = jax_make_optimizer(cfg, 4.0)
    opt, _ = make_optimizer(cfg, 4.0)
    params = [rng.randn(6, 4).astype(np.float32), rng.randn(4).astype(np.float32)]
    jparams = [jnp.asarray(p) for p in params]
    tparams = [torch.from_numpy(p.copy()) for p in params]
    jstate, tstate = tx.init(jparams), opt.init(tparams)
    for step in range(4):
        grads = [rng.randn(*p.shape).astype(np.float32) * (30.0 if step == 1 else 0.1)
                 for p in params]
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tstate = opt.update_(tparams, [torch.from_numpy(g) for g in grads], tstate)
        for t, j in zip(tparams, jparams):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {step}")


def test_checkpoint_roundtrip_keep_and_average(tmp_path):
    from omni_avsr_tpu_torch.train.checkpoint import (
        average_last_n,
        latest_checkpoint,
        list_checkpoints,
        restore_checkpoint,
        save_checkpoint,
    )
    from omni_avsr_tpu_torch.train.optim import make_optimizer

    opt, _ = make_optimizer(TrainConfig(), 10.0)
    trees = []
    for step in range(1, 5):
        g = torch.Generator().manual_seed(step)
        tree = {"proj": {"w": torch.randn(3, 2, generator=g)}, "lora": {"up": torch.randn(4, generator=g)}}
        masters = master_weights(tree, "cpu")
        state = TrainState(step, masters, opt.init(list(tree_leaves(masters))))
        save_checkpoint(str(tmp_path), step, state, keep=3)
        trees.append(tree)
    paths = list_checkpoints(str(tmp_path))
    assert [p.rsplit("_", 1)[1] for p in paths] == ["00000002.pt", "00000003.pt", "00000004.pt"]
    assert latest_checkpoint(str(tmp_path)) == paths[-1]
    back = restore_checkpoint(paths[-1], device="cpu")
    assert back.step == 4 and back.opt_state.count == 0
    for a, b in zip(tree_leaves(back.trainable), tree_leaves(trees[-1])):
        assert a.requires_grad and a.dtype == torch.float32
        torch.testing.assert_close(a.detach(), b, atol=0, rtol=0)
    avg = average_last_n(str(tmp_path), 2)
    for a, b, c in zip(tree_leaves(avg), tree_leaves(trees[2]), tree_leaves(trees[3])):
        torch.testing.assert_close(a, ((b.double() + c.double()) / 2).float(), atol=0, rtol=0)


def test_restore_checkpoint_defaults_to_the_card():
    """An entry point of the port puts what it returns on the card unless
    the caller asks for the CPU; read from the signature, no card needed."""
    import inspect

    from omni_avsr_tpu_torch.train.checkpoint import restore_checkpoint

    assert inspect.signature(restore_checkpoint).parameters["device"].default == "cuda"


def test_augmented_step_is_seeded_and_moves_the_masters(tiny):
    """augment=True: train-mode crop, time masks, babble noise, batch-stat
    BN, AV-HuBERT's dropouts and layerdrop, all from the engine's seed. Two
    engines with one seed give the same loss; the step moves every master
    that the sampled rates use."""
    from omni_avsr_tpu_torch.train.engine import OmniEngine

    jm, params = tiny
    raw = _raw_batch(jm.tok, seed=2)
    bank = (np.random.RandomState(0).randn(40000) * 0.1).astype(np.float32)
    losses = []
    for _ in range(2):
        pm = flagship(tiny=True, dtype=torch.float32, whisper_input_mode="bucket")
        pe = OmniEngine(pm, params_from_numpy(params, "cpu"), TrainConfig(lr=1e-3),
                        noise_bank=bank, seed=11, device="cpu")
        before = {k: v.copy() for k, v in _flat(pe.state.trainable).items()}
        losses.append(pe.train_step({**raw, "audio_trim_len": _trim()}).item())
        assert 0 <= pm.last_video_layers <= pm.cfg.avhubert.encoder_layers
        after = _flat(pe.state.trainable)
        moved = [k for k in before if not np.array_equal(before[k], after[k])]
        assert any(".lora.audiovisual." in k for k in moved) and any("avhubert." in k for k in moved)
    assert np.isfinite(losses[0]) and losses[0] == losses[1]


def test_layerdrop_draws():
    """AV-HuBERT's layer plan: without a generator every layer and no seeds;
    with one, each layer dropped at the config's rate (0.05 over 400 draws
    of 24 layers: 3.5-6.5%) and int32 attention-dropout seeds."""
    from omni_avsr_tpu_torch.config import avhubert_large
    from omni_avsr_tpu_torch.models.avhubert import layers_to_run

    cfg = avhubert_large()
    assert layers_to_run(cfg, None) == (list(range(24)), [None] * 24)
    g = torch.Generator().manual_seed(0)
    plans = [layers_to_run(cfg, g) for _ in range(400)]
    dropped = sum(24 - len(keep) for keep, _ in plans) / (400 * 24)
    assert 0.035 < dropped < 0.065, dropped
    assert all(0 <= s < 2**31 for _, seeds in plans for s in seeds)
    assert all(keep == sorted(set(keep)) for keep, _ in plans)
