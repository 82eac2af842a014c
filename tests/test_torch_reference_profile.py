"""The reference numerics profile of the port against the JAX package, at
the tiny flagship widths, f32 on both sides:

  - augmentation under a threefry key: `video_pipeline` and
    `audio_pipeline` in train mode (babble included) and the noisy-eval
    mix draw the JAX package's crops, masks, SNRs and noise offsets;
  - AV-HuBERT in train mode under a key (its dropout masks and layerdrop
    equal JAX's): atol 2e-4 / rtol 1e-3, the towers' tolerance;
  - `batch_norm_train(stats="twopass")` against JAX's `_bn` under
    `OMNI_BN_STATS=twopass`: 1e-6;
  - the three remat policies give the same losses and grads, with a key
    and with a generator (each layer's draws replay in the recompute);
  - the "full_llm" / "full_towers" trainable sets are JAX's;
  - `utils/profiles.resolve` applies JAX's precedence;
  - two `OmniEngine.train_step`s with augmentation and dropout on and
    `prng="threefry"` against the JAX engine under `OMNI_PRNG=threefry`:
    losses rtol 1e-5 and the engines' keys bit-equal after the steps; the
    masters within atol 1e-5 / rtol 1e-4 (the augment=False test's) on
    all but 0.1% of their elements and within one Adam step (1e-3) on
    every one (the reason is at the assertion).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omni_avsr_tpu_torch.bridge import params_from_numpy
from omni_avsr_tpu_torch.config import TrainConfig
from omni_avsr_tpu_torch.models.omni import flagship
from omni_avsr_tpu_torch.utils import prng
from tests.torch_parity import jax_in_f32, jax_tiny_flagship, jax_tiny_params

B, FRAMES, TOKENS = 2, 8, 6
BANK = (np.random.RandomState(77).randn(16000) * 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    jm = jax_tiny_flagship()
    return jm, jax_tiny_params(jm)


def _raw_batch(tok, seed=0):
    """tests/test_torch_train.py's batch: 96x96 RGB frames, 16 kHz audio,
    padded ids and labels."""
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
    from omni_avsr_tpu_torch.ops.audio_frontend import whisper_token_len

    return ((int(whisper_token_len(torch.tensor(FRAMES * 640))) + 24) // 25) * 25


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(
            v.detach().numpy() if isinstance(v, torch.Tensor) else v)})
    return out


@pytest.mark.parametrize("seed", [0, 42])
def test_augmentation_under_a_key_matches_jax(seed):
    """Train-mode video and audio pipelines (40 frames, 2.6 s of audio: two
    time masks of each kind) and the noisy-eval mix under the same key."""
    from omni_avsr_tpu.ops import augment as jaug

    from omni_avsr_tpu_torch.ops import augment as taug

    rng = np.random.RandomState(seed)
    video = rng.randint(0, 255, (3, 40, 96, 96, 3)).astype(np.uint8)
    vlen = np.asarray([40, 31, 26], np.int32)
    audio = (rng.randn(3, 41600) * 0.1).astype(np.float32)
    alen = np.asarray([41600, 30000, 20000], np.int32)
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)

    want = np.asarray(jaug.video_pipeline(jk, video, vlen, True))
    got = taug.video_pipeline(torch.from_numpy(video), torch.from_numpy(vlen), train=True,
                              generator=tk).numpy()
    np.testing.assert_array_equal(got == (0.0 - 0.421) / 0.165, want == (0.0 - 0.421) / 0.165)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    want = np.asarray(jaug.audio_pipeline(jk, audio, alen, True, noise_bank=jnp.asarray(BANK)))
    got = taug.audio_pipeline(torch.from_numpy(audio), torch.from_numpy(alen), train=True,
                              generator=tk, noise_bank=torch.from_numpy(BANK)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    want = np.asarray(jaug.audio_pipeline(jk, audio, alen, False, noise_bank=jnp.asarray(BANK),
                                          snr_target=0.0))
    got = taug.audio_pipeline(torch.from_numpy(audio), torch.from_numpy(alen), generator=tk,
                              noise_bank=torch.from_numpy(BANK), snr_target=0.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the draws themselves, bit for bit
    k_mask = jax.random.split(jk, 3)[0]
    jmask = np.asarray(jaug.adaptive_time_mask(k_mask, jnp.ones((3, 41600)), alen, 6400, 16000,
                                               4))
    tmask = taug.adaptive_time_mask(prng.split(tk, 3)[0], torch.ones(3, 41600),
                                    torch.from_numpy(alen), 6400, 16000, 4).numpy()
    np.testing.assert_array_equal(tmask, jmask)
    np.testing.assert_array_equal(
        taug.crop_video(tk, torch.from_numpy(video), 88, train=True).numpy(),
        np.asarray(jaug.crop_video(jk, video, 88, train=True)))
    np.testing.assert_array_equal(
        taug.horizontal_flip(tk, torch.from_numpy(video)).numpy(),
        np.asarray(jaug.horizontal_flip(jk, video)))


def test_avhubert_train_mode_under_a_key_matches_jax(tiny):
    """AV-HuBERT with the ResNet's batch statistics and every dropout and
    layerdrop draw of one key."""
    from omni_avsr_tpu.models.avhubert import avhubert_encode as jencode

    from omni_avsr_tpu_torch.models.avhubert import avhubert_encode

    jm, params = tiny
    cfg = flagship(tiny=True, dtype=torch.float32).cfg.avhubert
    video = np.random.RandomState(4).randn(2, 12, 88, 88, 1).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params["avhubert"])
    tp = params_from_numpy(params["avhubert"], "cpu")
    jfn = jax.jit(lambda p, v, k: jencode(p, jm.cfg.avhubert, v, train_mode=True, rng=k))
    for seed in (0, 5):
        want = np.asarray(jfn(jp, jnp.asarray(video), jax.random.PRNGKey(seed)))
        got = avhubert_encode(tp, cfg, torch.from_numpy(video), train_mode=True,
                              generator=prng.PRNGKey(seed)).numpy()
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    no_drop = avhubert_encode(tp, cfg, torch.from_numpy(video), train_mode=True).numpy()
    assert not np.allclose(no_drop, want, atol=1e-2)  # the draws did something


def test_twopass_batch_norm_matches_jax(monkeypatch, tiny):
    from omni_avsr_tpu.models import resnet3d as jres

    from omni_avsr_tpu_torch.models.resnet3d import batch_norm_train, resnet3d_forward

    monkeypatch.setenv("OMNI_BN_STATS", "twopass")
    rng = np.random.RandomState(8)
    x = (rng.randn(6, 11, 13, 64) + 0.5).astype(np.float32)  # conv-output scale
    p = {"scale": rng.rand(64).astype(np.float32) + 0.5,
         "bias": rng.randn(64).astype(np.float32)}
    tp = params_from_numpy(p, "cpu")
    want = np.asarray(jres._bn(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p), True))
    got = batch_norm_train(torch.from_numpy(x), tp, stats="twopass")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    # far from zero the two forms part: two passes stay with the f64 statistics
    x = (rng.randn(6, 11, 13, 64) * 0.05 + 40.0).astype(np.float32)
    x64 = x.astype(np.float64)
    ref = ((x64 - x64.mean(axis=(0, 1, 2))) / np.sqrt(x64.var(axis=(0, 1, 2)) + 1e-5)
           * p["scale"] + p["bias"])
    err = {stats: np.abs(batch_norm_train(torch.from_numpy(x), tp, stats=stats).numpy() - ref
                         ).max() for stats in ("onepass", "twopass")}
    assert err["twopass"] < 1e-2 < err["onepass"], err
    # through the whole ResNet (stem and blocks): the towers' tolerance
    _, params = tiny
    jp = params["avhubert"]["video_frontend"]
    video = rng.randn(2, 5, 88, 88, 1).astype(np.float32)
    want = np.asarray(jres.resnet3d_forward(jax.tree_util.tree_map(jnp.asarray, jp),
                                            jnp.asarray(video), train_mode=True))
    got = resnet3d_forward(params_from_numpy(jp, "cpu"), torch.from_numpy(video),
                           train_mode=True, bn_stats="twopass")
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("route", ["threefry", "torch"])
def test_remat_policies_give_equal_losses_and_grads(tiny, route):
    """One train loss with augmentation and dropout on, and its grads, under
    "off", "dots" and "full": the same draws (the key, or the re-seeded
    generator), the same values."""
    from omni_avsr_tpu_torch.train.engine import OmniEngine
    from omni_avsr_tpu_torch.train.state import tree_leaves

    jm, params = tiny
    pm = flagship(tiny=True, dtype=torch.float32, whisper_input_mode="bucket")
    raw = _raw_batch(jm.tok, seed=2)
    results = {}
    for policy in ("off", "dots", "full"):
        pe = OmniEngine(pm, params_from_numpy(params, "cpu"), TrainConfig(lr=1e-3), seed=0,
                        device="cpu", noise_bank=BANK, prng=route, remat=policy)
        arrays, trim = pe._arrays({**raw, "audio_trim_len": _trim()})
        pe.generator.manual_seed(123)
        key = prng.PRNGKey(9) if route == "threefry" else None
        total, _ = pe._loss(arrays, 4, 2, trim, is_train=True, key=key)
        leaves = list(tree_leaves(pe.state.trainable))
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        results[policy] = (total.item(), [g for g in grads if g is not None])
    base_loss, base_grads = results["off"]
    assert len(base_grads) > 10
    for policy in ("dots", "full"):
        loss, grads = results[policy]
        np.testing.assert_allclose(loss, base_loss, rtol=1e-6, err_msg=policy)
        for g, b in zip(grads, base_grads):
            np.testing.assert_allclose(g.numpy(), b.numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=policy)


@pytest.mark.parametrize("unfrozen", [("full_llm",), ("full_towers",),
                                      ("full_llm", "full_towers"),
                                      ("peft_llm", "lora_avhubert")])
def test_trainable_sets_match_jax(tiny, unfrozen):
    jm, params = tiny
    pm = flagship(tiny=True, dtype=torch.float32)
    paths = list(_flat(params))
    want = {p for p in paths if jm.trainable_predicate(unfrozen)(p)}
    got = {p for p in paths if pm.trainable_predicate(unfrozen)(p)}
    assert got == want and got


@pytest.mark.parametrize("env", [
    {"OMNI_PROFILE": "reference"},
    {"OMNI_PROFILE": "reference", "OMNI_BEAM_ATTN": "kernel", "OMNI_REMAT": "full"},
    {"OMNI_PROFILE": "reference", "OMNI_PRNG": "threefry"},
    {"OMNI_PROFILE": "tpu", "OMNI_BN_STATS": "twopass"},
    {"OMNI_REMAT": "off", "OMNI_BEAM_SELECT": "grid", "OMNI_SELECT_KERNEL": "1"},
], ids=["reference", "overrides", "agreeing", "tpu", "no-profile"])
def test_profiles_resolve_like_jax(monkeypatch, capsys, env):
    import os

    from omni_avsr_tpu.utils.profiles import REFERENCE_PROFILE as JAX_REFERENCE
    from omni_avsr_tpu.utils.profiles import apply_profile as jax_apply

    from omni_avsr_tpu_torch.utils.profiles import REFERENCE_PROFILE, apply_profile, resolve

    assert REFERENCE_PROFILE == JAX_REFERENCE
    names = list(JAX_REFERENCE) + ["OMNI_PROFILE"]
    for var in names:  # recorded, so that the JAX call's writes are undone
        monkeypatch.setenv(var, "x")
        monkeypatch.delenv(var)
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    given = dict(os.environ)
    ours, applied, kept = apply_profile(env.get("OMNI_PROFILE"), given)
    assert dict(os.environ) == given  # the port's function writes nothing
    jax_applied = jax_apply(env.get("OMNI_PROFILE"), verbose=False)
    assert applied == jax_applied
    assert {k: v for k, v in ours.items() if k in names} == {
        k: v for k, v in os.environ.items() if k in names}
    assert set(kept) == {k for k in env if k in JAX_REFERENCE
                         and env.get("OMNI_PROFILE") == "reference"
                         and JAX_REFERENCE[k] != env[k]}
    num = resolve(given)
    if kept:
        assert "explicit overrides kept" in capsys.readouterr().out
    assert num.remat == ours.get("OMNI_REMAT", "dots")
    assert num.beam_attn == ours.get("OMNI_BEAM_ATTN")
    assert num.prng == ("threefry" if ours.get("OMNI_PRNG") == "threefry" else "torch")
    assert num.select_kernel == (ours.get("OMNI_SELECT_KERNEL", "0") not in ("0", ""))
    # OMNI_SP=1 is `--sequence-parallel`: it reaches the engine under a tp mesh
    assert resolve({**given, "OMNI_SP": "1"}).sp


def test_engine_steps_match_jax_with_augment_and_dropout(monkeypatch, tiny):
    """tests/test_torch_train.py's two-step test with augmentation and
    dropout on, babble in the bank: the JAX engine under
    `OMNI_PRNG=threefry` (set before it is built, since it reads it there)
    and the port's `OmniEngine(prng="threefry")` from the same seed draw
    the same crops, masks, SNRs, noise offsets, dropout masks and
    layerdrop, so the losses and the trainable tree after the steps agree
    at the augment=False test's tolerances."""
    import omni_avsr_tpu.train.state as jstate
    from omni_avsr_tpu.config import TrainConfig as JaxTrainConfig
    from omni_avsr_tpu.train.engine import OmniEngine as JaxEngine

    from omni_avsr_tpu_torch.train.engine import OmniEngine

    jax_in_f32(monkeypatch)
    monkeypatch.setattr(jstate.make_train_step, "__defaults__", (jnp.float32,))
    monkeypatch.setenv("OMNI_PRNG", "threefry")
    jm, params = tiny
    raw = _raw_batch(jm.tok, seed=1)
    je = JaxEngine(jm, jax.tree_util.tree_map(jnp.asarray, params), JaxTrainConfig(lr=1e-3),
                   augment=True, seed=3, noise_bank=BANK)
    pm = flagship(tiny=True, dtype=torch.float32, whisper_input_mode="bucket")
    pe = OmniEngine(pm, params_from_numpy(params, "cpu"), TrainConfig(lr=1e-3), augment=True,
                    seed=3, device="cpu", noise_bank=BANK, prng="threefry")
    for step in range(2):
        jloss = float(je.train_step({**raw, "audio_trim_len": _trim()}))
        loss = pe.train_step({**raw, "audio_trim_len": _trim()})
        np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5, err_msg=f"step {step}")
    np.testing.assert_array_equal(pe._rng_key.numpy().astype(np.uint32),
                                  np.asarray(je._rng_key).astype(np.uint32))
    want = _flat(jax.device_get(je.state.trainable))
    got = _flat(pe.state.trainable)
    assert got.keys() == want.keys()
    # The train-mode ResNet amplifies f32 rounding (its forward is held at
    # rtol 1e-3 in tests/test_torch_train.py), so the grads behind it agree
    # to ~6e-4 relative here, not the ~1e-5 of augment=False. Adam turns a
    # grad within f32 noise of zero, or two steps' grads that nearly
    # cancel, into a step of either sign: 12 of the 70272 master elements
    # land outside atol 1e-5 / rtol 1e-4, by at most 8.3e-4. Hence: every
    # element within one Adam step (lr 1e-3) of JAX's, and all but 0.1%
    # within the augment=False test's tolerance.
    outside = total = 0
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=1e-3, rtol=0, err_msg=path)
        outside += int((np.abs(got[path] - want[path]) > 1e-5 + 1e-4 * np.abs(want[path])).sum())
        total += want[path].size
    assert outside <= total // 1000, (outside, total)
