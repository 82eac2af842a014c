"""The port's decode prefix against the JAX package: the Whisper log-mel
frontend (30 s and bucketed windows), the eval-mode preprocessing, and
`infer_prefix_masked`, whose per-sample gap slots must be masked exactly as
in JAX. In f32: the JAX prefix path names bf16 for its activations, and is
redirected to f32 here (tests/torch_parity.py::jax_in_f32) so that the two
frameworks' different bf16 rounding places do not decide the comparison."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omni_avsr_tpu_torch.bridge import init_params, params_from_numpy
from omni_avsr_tpu_torch.models.omni import flagship
from omni_avsr_tpu_torch.serve import pad_batch
from tests.torch_parity import clips, jax_in_f32, jax_tiny_flagship, randomize_lora_down


@pytest.mark.parametrize("num_frames", [650, 3000])
def test_log_mel_spectrogram(num_frames):
    from omni_avsr_tpu.ops.audio_frontend import log_mel_spectrogram as jmel
    from omni_avsr_tpu_torch.ops.audio_frontend import log_mel_spectrogram

    rng = np.random.RandomState(0)
    audio = (rng.randn(2, 104000) * 0.1).astype(np.float32)
    lengths = np.array([104000, 61000], np.int32)
    ref = np.asarray(jax.jit(lambda a, n: jmel(a, n, num_frames=num_frames))(
        jnp.asarray(audio), jnp.asarray(lengths)))
    ours = log_mel_spectrogram(torch.from_numpy(audio), torch.from_numpy(lengths), num_frames)
    assert ours.shape == (2, num_frames, 80)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_eval_pipelines():
    from omni_avsr_tpu.ops.augment import audio_pipeline as japp, video_pipeline as jvpp
    from omni_avsr_tpu_torch.ops.augment import audio_pipeline, video_pipeline

    rng = np.random.RandomState(1)
    video = rng.randint(0, 255, (2, 7, 96, 96, 3), dtype=np.uint8)
    vlen = np.array([7, 4], np.int32)
    audio = (rng.randn(2, 7 * 640) * 0.3 + 0.05).astype(np.float32)
    alen = np.array([7 * 640, 2000], np.int32)
    jv = np.asarray(jvpp(None, jnp.asarray(video), jnp.asarray(vlen), train=False))
    tv = video_pipeline(torch.from_numpy(video), torch.from_numpy(vlen)).numpy()
    assert tv.shape == (2, 7, 88, 88, 1)
    np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=1e-5)
    ja = np.asarray(japp(None, jnp.asarray(audio), jnp.asarray(alen), train=False))
    ta = audio_pipeline(torch.from_numpy(audio), torch.from_numpy(alen)).numpy()
    np.testing.assert_allclose(ta, ja, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def tiny_params():
    """numpy f32 tree at the tiny flagship widths (LoRA downs randomised)."""
    model = flagship(tiny=True, dtype=torch.float32)
    params = init_params(model.cfg, torch.Generator().manual_seed(1), "cpu",
                         frozen_dtype=torch.float32)

    def to_numpy(node):
        return {k: (to_numpy(v) if isinstance(v, dict) else v.numpy()) for k, v in node.items()}

    return randomize_lora_down(to_numpy(params))


@pytest.mark.parametrize("modality", ["audiovisual", "audio", "video"])
def test_infer_prefix_masked(monkeypatch, tiny_params, modality):
    from omni_avsr_tpu.ops.augment import audio_pipeline as japp, video_pipeline as jvpp

    from omni_avsr_tpu_torch.ops.augment import audio_pipeline, video_pipeline

    jax_in_f32(monkeypatch)
    jm = jax_tiny_flagship()
    pm = flagship(tiny=True, dtype=torch.float32)
    items = clips((20, 33), seed=2)
    if modality != "audiovisual":
        items = [{modality: it[modality]} for it in items]
    batch, trim = pad_batch(items, modality)

    def jfn(p, b):
        b = dict(b)
        if "video" in b:
            b["video"] = jvpp(None, b["video"], b["video_len"], train=False)
        if "audio" in b:
            b["audio"] = japp(None, b["audio"], b["audio_len"], train=False)
        return jm.infer_prefix_masked(p, b, modality, 4, 2, trim)

    jp = jax.tree_util.tree_map(jnp.asarray, tiny_params)
    jemb, jvalid = jax.jit(jfn)(jp, {k: jnp.asarray(v) for k, v in batch.items()})

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if "video" in tb:
        tb["video"] = video_pipeline(tb["video"], tb["video_len"])
    if "audio" in tb:
        tb["audio"] = audio_pipeline(tb["audio"], tb["audio_len"])
    temb, tvalid = pm.infer_prefix_masked(params_from_numpy(tiny_params, "cpu"), tb, modality,
                                          4, 2, trim)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    # the gaps: each sample keeps exactly its own audio and video token counts
    n_a = max(20 * 640 * 50 // 16000, 25) // 4, max(33 * 640 * 50 // 16000, 25) // 4
    n_v = 20 // 2, 33 // 2
    fixed = 1 + len(pm.prompt_ids[modality])
    fixed += 2 * (modality != "video") + 2 * (modality != "audio")
    want = [fixed + n_a[b] * (modality != "video") + n_v[b] * (modality != "audio") for b in (0, 1)]
    assert tvalid.sum(dim=1).tolist() == want
    assert not tvalid.all()
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), atol=2e-4, rtol=1e-3)
