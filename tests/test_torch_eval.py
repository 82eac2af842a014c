"""The noisy evaluation of the port against the JAX package's: babble mixed
at a fixed SNR by `audio_pipeline`'s eval branch, and
`OmniEngine.decode_batch` with `decode_snr_target`, at the tiny flagship
widths (bucketed window), in f32 on both sides
(`tests/torch_parity.py::jax_in_f32`), the JAX side on the ancestor route
(`OMNI_BEAM_ATTN=kernel`).

The noise bank is one sample longer than the padded waveform, so both
packages draw the offset 0 (from [0, 1)) and the mix is deterministic.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omni_avsr_tpu_torch.bridge import params_from_numpy
from omni_avsr_tpu_torch.serve import pad_batch
from tests.torch_parity import clips, jax_in_f32, jax_tiny_flagship, jax_tiny_params, port_model


@pytest.mark.parametrize("snr", [0.0, -5.0, 20.0, 999999.0, None])
def test_eval_noise_matches_jax(snr):
    """Eval preprocessing with a noise bank: mixed at `snr` (not at the
    clean choice 999999 or without a target), then standardised."""
    from omni_avsr_tpu.ops.augment import audio_pipeline as japp
    from omni_avsr_tpu_torch.ops.augment import audio_pipeline

    rng = np.random.RandomState(3)
    S = 12800
    audio = (rng.randn(2, S) * 0.3).astype(np.float32)
    lengths = np.array([S, 9000], np.int32)
    bank = (rng.randn(S + 1) * 0.2).astype(np.float32)
    ref = np.asarray(japp(jax.random.PRNGKey(5), jnp.asarray(audio), jnp.asarray(lengths),
                          train=False, noise_bank=jnp.asarray(bank), snr_target=snr))
    ours = audio_pipeline(torch.from_numpy(audio), torch.from_numpy(lengths),
                          generator=torch.Generator().manual_seed(5),
                          noise_bank=torch.from_numpy(bank), snr_target=snr).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)
    clean = audio_pipeline(torch.from_numpy(audio), torch.from_numpy(lengths)).numpy()
    mixed = snr is not None and snr < 999998
    assert (np.abs(ours - clean).max() > 1e-2) == mixed


@pytest.fixture(scope="module")
def tiny():
    jm = jax_tiny_flagship()
    items = clips((40, 33, 48), seed=11)
    batch, trim = pad_batch(items, "audiovisual")
    return jm, port_model(jm), jax_tiny_params(jm), batch, trim


@pytest.mark.parametrize("snr,with_bank,beams", [(0.0, True, 15), (5.0, False, 1)],
                         ids=["snr0-bank-beam15", "snr5-no-bank-greedy"])
def test_decode_batch_matches_jax(monkeypatch, tiny, snr, with_bank, beams):
    """`OmniEngine.decode_batch(params, batch, modality, rate_a, rate_v,
    num_beams, max_new)` gives the JAX engine's strings, by beam search and
    by greedy decoding; without a noise bank the target SNR leaves the
    audio clean, as in JAX."""
    from omni_avsr_tpu.config import TrainConfig as JaxTrainConfig
    from omni_avsr_tpu.train.engine import OmniEngine as JaxEngine
    from omni_avsr_tpu_torch.config import TrainConfig
    from omni_avsr_tpu_torch.train.engine import OmniEngine

    jax_in_f32(monkeypatch)
    monkeypatch.setenv("OMNI_BEAM_ATTN", "kernel")
    jm, pm, params, batch, trim = tiny
    bank = ((np.random.RandomState(12).randn(batch["audio"].shape[1] + 1) * 0.1)
            .astype(np.float32) if with_bank else None)
    full = {**batch, "audio_trim_len": trim}
    je = JaxEngine(jm, jax.tree_util.tree_map(jnp.asarray, params), JaxTrainConfig(), 1.0,
                   noise_bank=bank, decode_snr_target=snr, inference_only=True)
    want = je.decode_batch(je.merged_params(), dict(full), "audiovisual", 4, 2, num_beams=beams,
                           max_new=32)
    pe = OmniEngine(pm, params_from_numpy(params, "cpu"), TrainConfig(), 1.0, noise_bank=bank,
                    decode_snr_target=snr, device="cpu")
    got = pe.decode_batch(pe.merged_params(), dict(full), "audiovisual", 4, 2, num_beams=beams,
                          max_new=32)
    assert got == want
    assert all(got) and 1 <= pe.last_decode_steps <= 32
