"""Invariants of the port's train-mode augmentation (`ops/augment.py`).

`jax.random` and `torch.Generator` draw different bits from one seed, so
the random branches are held to what they must do, not to the JAX
package's values: shapes and dtypes, the masked fraction's bounds, a crop
that is a window of the input, an exact flip, the requested SNR. The eval
branches are compared with the JAX package's value for value.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from omni_avsr_tpu_torch.ops.augment import (
    adaptive_time_mask,
    add_noise_snr,
    audio_pipeline,
    crop_video,
    horizontal_flip,
    video_pipeline,
)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_train_branches_shapes_and_dtypes():
    rng = np.random.RandomState(0)
    video = torch.from_numpy(rng.randint(0, 255, (2, 30, 96, 96, 3)).astype(np.uint8))
    vlen = torch.tensor([30, 21], dtype=torch.int32)
    out = video_pipeline(video, vlen, train=True, generator=_gen(1))
    assert out.shape == (2, 30, 88, 88, 1) and out.dtype == torch.float32
    audio = torch.from_numpy((rng.randn(2, 30 * 640) * 0.1).astype(np.float32))
    alen = torch.tensor([30 * 640, 12000], dtype=torch.int32)
    bank = torch.from_numpy(rng.randn(50000).astype(np.float32))
    a = audio_pipeline(audio, alen, train=True, generator=_gen(2), noise_bank=bank)
    assert a.shape == audio.shape and a.dtype == torch.float32
    assert bool(torch.isfinite(a).all())
    assert bool((a[1, 12000:] == 0).all())  # the padding stays zero


@pytest.mark.parametrize("seed", range(4))
def test_time_mask_fraction_within_bounds(seed):
    """n = int((len + stride - 0.1) // stride) masks of width < window each:
    at most n * (window - 1) steps of a clip are zeroed, none of another."""
    T, window, stride = 400, 10, 25
    lengths = torch.tensor([400, 250, 26, 1])
    x = torch.ones(4, T, 3)
    y = adaptive_time_mask(_gen(seed), x, lengths, window, stride, (T + stride) // stride + 1)
    assert y.shape == x.shape and set(torch.unique(y).tolist()) <= {0.0, 1.0}
    assert bool((y == y[..., :1]).all())  # whole time steps, every channel
    masked = (y[..., 0] == 0).sum(dim=1)
    n = torch.floor((lengths.float() + stride - 0.1) / stride)
    assert bool((masked <= n * (window - 1)).all()), (masked, n)
    many = adaptive_time_mask(_gen(seed + 10), torch.ones(64, T), torch.full((64,), T), window,
                              stride, (T + stride) // stride + 1)
    frac = (many == 0).float().mean().item()
    assert 0.05 < frac < 16 * 9 / T  # ~16 masks of mean width 4.5, overlapping


def test_random_crop_is_a_window_and_flip_is_exact():
    B, T, H, W = 3, 4, 96, 96
    pos = (torch.arange(H)[:, None] * 1000 + torch.arange(W)[None, :]).float()
    video = pos[None, None, :, :, None].expand(B, T, H, W, 2).clone()
    video[1] += 7.0
    out = crop_video(_gen(5), video, 88, train=True)
    assert out.shape == (B, T, 88, 88, 2)
    for b in range(B):
        corner = out[b, 0, 0, 0, 0].item() - (7.0 if b == 1 else 0.0)
        oh, ow = int(corner // 1000), int(corner % 1000)
        assert 0 <= oh <= 8 and 0 <= ow <= 8
        torch.testing.assert_close(out[b], video[b, :, oh:oh + 88, ow:ow + 88], atol=0, rtol=0)
    flipped = horizontal_flip(_gen(6), video, p=0.5)
    for b in range(B):
        assert torch.equal(flipped[b], video[b]) or torch.equal(flipped[b], video[b].flip(2))
    always = horizontal_flip(_gen(6), video, p=1.0)
    torch.testing.assert_close(always, video.flip(3), atol=0, rtol=0)
    torch.testing.assert_close(horizontal_flip(_gen(6), video, p=0.0), video, atol=0, rtol=0)


@pytest.mark.parametrize("snr", [-5.0, 0.0, 20.0])
def test_noise_mixed_at_the_requested_snr(snr):
    rng = np.random.RandomState(1)
    speech = torch.from_numpy(rng.randn(3, 8000).astype(np.float32))
    lengths = torch.tensor([8000, 5000, 6000])
    bank = torch.from_numpy(rng.randn(30000).astype(np.float32))
    mixed = add_noise_snr(_gen(3), speech, lengths, bank, torch.full((3,), snr))
    for b, n in enumerate(lengths.tolist()):
        s = speech[b, :n].double()
        noise = mixed[b, :n].double() - s
        measured = 10 * torch.log10(s.square().sum() / noise.square().sum()).item()
        assert abs(measured - snr) < 1e-3
        assert bool((mixed[b, n:] == 0).all())


def test_eval_branches_match_jax():
    from omni_avsr_tpu.ops.augment import audio_pipeline as jax_audio
    from omni_avsr_tpu.ops.augment import video_pipeline as jax_video

    rng = np.random.RandomState(4)
    video = rng.randint(0, 255, (2, 6, 96, 96, 3)).astype(np.uint8)
    vlen = np.asarray([6, 4], np.int32)
    audio = (rng.randn(2, 6 * 640) * 0.1).astype(np.float32)
    alen = np.asarray([6 * 640, 2000], np.int32)
    ours = video_pipeline(torch.from_numpy(video), torch.from_numpy(vlen))
    ref = np.asarray(jax_video(None, jnp.asarray(video), jnp.asarray(vlen), train=False))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=1e-6)
    ours = audio_pipeline(torch.from_numpy(audio), torch.from_numpy(alen))
    ref = np.asarray(jax_audio(None, jnp.asarray(audio), jnp.asarray(alen), train=False))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=1e-5)
