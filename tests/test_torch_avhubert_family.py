"""Parity of the port's AV-HuBERT family pieces with the JAX package, at
tiny widths in f32: the stacked filterbanks (`data/audio_features.py`,
exact), AV-HuBERT with audio and `output_layer` (atol 2e-4 / rtol 1e-3,
the towers' tolerance), the pre-training video pipeline and span mask
(bit-equal under a threefry key), the masked-prediction loss and its aux
metrics (rtol 1e-4), the unit discovery's MFCC and k-means (exact, numpy
on both sides) and the layer-N reader of `cluster_units` against the JAX
`avhubert_encode(..., output_layer=N)`.

One tree is made per file, from a torch generator, and handed to both
sides; the JAX side runs eagerly, which compiles each op once for all the
cases.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni_avsr_tpu.config import AVHubertConfig as JCfg
from omni_avsr_tpu_torch.bridge import init_avhubert, init_pretrain_head
from omni_avsr_tpu_torch.config import AVHubertConfig as PCfg
from omni_avsr_tpu_torch.utils import prng

TOWER_TOL = dict(atol=2e-4, rtol=1e-3)
KW = dict(encoder_embed_dim=32, encoder_layers=3, encoder_heads=4, encoder_ffn_dim=64,
          audio_feat_dim=104, lora_rank_divisor=None)
B, T = 2, 8
LENS = np.array([8, 6], np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def enc():
    """(numpy tree, port tree, numpy head, port head) of the tiny encoder and
    a pre-training head, made from a torch generator (`bridge.py`)."""
    g = torch.Generator().manual_seed(0)
    tp, th = init_avhubert(PCfg(**KW), g, "cpu"), init_pretrain_head(PCfg(**KW), 6, 16, g, "cpu")
    np_tree = lambda t: jax.tree_util.tree_map(lambda x: x.numpy(), t)  # noqa: E731
    return np_tree(tp), tp, np_tree(th), th


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(3)
    return (rng.randn(B, T, 88, 88, 1).astype(np.float32),
            rng.randn(B, T, 104).astype(np.float32))


def test_audio_features_equal_jax():
    from omni_avsr_tpu.data import audio_features as ja
    from omni_avsr_tpu_torch.data import audio_features as pa

    rng = np.random.RandomState(0)
    audio = (rng.randn(24 * 640) * 0.1).astype(np.float32)
    np.testing.assert_array_equal(pa._mel_filters(26, 512, 16000), ja._mel_filters(26, 512, 16000))
    np.testing.assert_array_equal(pa.logfbank(audio), ja.logfbank(audio))
    np.testing.assert_array_equal(pa.stacker(pa.logfbank(audio)), ja.stacker(ja.logfbank(audio)))
    for normalize in (True, False):
        np.testing.assert_array_equal(pa.stacked_fbank(audio, 30, normalize),
                                      ja.stacked_fbank(audio, 30, normalize))
    batch = np.stack([audio, audio[::-1].copy()])
    lens = np.array([24 * 640, 17 * 640 + 5])
    got = pa.batch_stacked_fbank(batch, lens, 24)
    assert got.shape == (2, 24, 104) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ja.batch_stacked_fbank(batch, lens, 24))


@pytest.mark.parametrize("output_layer", [None, 0, 2])
@pytest.mark.parametrize("modality", ["audio", "video", "audiovisual"])
def test_avhubert_with_audio_matches_jax(enc, inputs, modality, output_layer):
    from omni_avsr_tpu.models.avhubert import avhubert_encode as jencode
    from omni_avsr_tpu_torch.models.avhubert import avhubert_encode

    jp, tp = enc[:2]
    video, audio = inputs
    v = video if modality != "audio" else None
    a = audio if modality != "video" else None
    want = np.asarray(jencode(jp, JCfg(**KW), None if v is None else jnp.asarray(v),
                              None if a is None else jnp.asarray(a), jnp.asarray(LENS),
                              output_layer=output_layer))
    got = avhubert_encode(tp, PCfg(**KW), None if v is None else _t(v),
                          audio=None if a is None else _t(a), lengths=_t(LENS),
                          output_layer=output_layer)
    assert tuple(got.shape) == (B, T, 32)
    np.testing.assert_allclose(got.numpy(), want, **TOWER_TOL)


def test_video_none_runs_no_trunk(enc, inputs, monkeypatch):
    import omni_avsr_tpu_torch.models.avhubert as pav

    def no_trunk(*a, **k):
        raise AssertionError("the ResNet trunk ran without video")

    monkeypatch.setattr(pav, "resnet3d_forward", no_trunk)
    out = pav.avhubert_encode(enc[1], PCfg(**KW), None, audio=_t(inputs[1]))
    assert tuple(out.shape) == (B, T, 32)


def test_output_layer_under_remat_and_threefry_plan(enc, inputs):
    """`output_layer` under a remat policy gives the same values; a threefry
    key's plan at output_layer N has N layer keys, JAX's `split(k_layers, N)`."""
    from omni_avsr_tpu_torch.models.avhubert import avhubert_encode, layers_to_run

    tp = {k: v for k, v in enc[1].items()}
    master = {k: v.clone().requires_grad_(True) for k, v in tp["post_extract_proj"].items()}
    tp["post_extract_proj"] = master
    video, audio = inputs
    outs = [avhubert_encode(tp, PCfg(**KW), _t(video), audio=_t(audio), output_layer=2,
                            remat=remat) for remat in ("off", "full", "dots")]
    for o in outs[1:]:
        np.testing.assert_allclose(o.detach().numpy(), outs[0].detach().numpy(), atol=1e-6)
    outs[1].sum().backward()
    assert master["w"].grad is not None
    cfg = PCfg(**KW)
    key = prng.PRNGKey(5)
    keep, keys, _ = layers_to_run(cfg, key, output_layer=2)
    k_enc = prng.split(key)[1]  # after the input dropout's split
    want = jax.random.split(jax.random.split(jax.random.split(jax.random.PRNGKey(5))[1])[1], 2)
    assert np.array_equal(np.stack([np.asarray(k) for k in keys]), np.asarray(want))
    assert np.array_equal(prng.split(k_enc)[1].numpy(), np.asarray(
        jax.random.split(jax.random.split(jax.random.PRNGKey(5))[1])[1]))


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("seed", [0, 7])
def test_pretrain_video_pipeline_bit_equal(train, seed, channels):
    """Gray frames: bit-equal (the crop offsets and flips drawn as JAX draws
    them). RGB frames: within 1e-6, since XLA computes the luma as fused
    multiply-adds and torch's product rounds each term."""
    from omni_avsr_tpu.ops.augment import pretrain_video_pipeline as jpipe
    from omni_avsr_tpu_torch.ops.augment import pretrain_video_pipeline

    video = np.random.RandomState(seed).randint(0, 255, (6, 5, 96, 96, channels))
    video = video.astype(np.uint8)
    want = np.asarray(jpipe(jax.random.PRNGKey(seed) if train else None, jnp.asarray(video),
                            train))
    got = pretrain_video_pipeline(_t(video), train, prng.PRNGKey(seed) if train else None)
    if channels == 1:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("with_lengths", [True, False])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_span_mask_bit_equal(seed, with_lengths):
    from omni_avsr_tpu.models.avhubert_pretrain import compute_span_mask as jmask
    from omni_avsr_tpu_torch.models.avhubert_pretrain import compute_span_mask

    lens = np.array([50, 37, 12, 64], np.int32)
    want = np.asarray(jmask(jax.random.PRNGKey(seed), 4, 64,
                            jnp.asarray(lens) if with_lengths else None, 0.8, 10))
    got = compute_span_mask(prng.PRNGKey(seed), 4, 64, _t(lens) if with_lengths else None,
                            0.8, 10)
    assert got.dtype == torch.bool and got.any()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_pretrain_loss_and_aux_match_jax(enc, seed):
    """Modality dropout on (every draw under the key), masked and unmasked
    terms both weighted."""
    from omni_avsr_tpu.models.avhubert_pretrain import avhubert_pretrain_loss as jloss
    from omni_avsr_tpu_torch.models.avhubert_pretrain import avhubert_pretrain_loss

    jp, tp, jh, th = enc
    rng = np.random.RandomState(seed)
    vf, af = (rng.randn(B, T, 32).astype(np.float32) for _ in range(2))
    targets = rng.randint(0, 6, (B, T)).astype(np.int32)
    kw = dict(mask_prob=0.5, mask_length=3, modality_dropout=0.9, audio_dropout=0.5,
              pred_nomask_weight=0.5)
    wl, wa = jloss(jp, jh, JCfg(**KW), jnp.asarray(vf), jnp.asarray(af), jnp.asarray(targets),
                   jnp.asarray(LENS), jax.random.PRNGKey(seed), **kw)
    gl, ga = avhubert_pretrain_loss(tp, th, PCfg(**KW), _t(vf), _t(af), _t(targets), _t(LENS),
                                    prng.PRNGKey(seed), **kw)
    np.testing.assert_allclose(float(gl), float(wl), rtol=1e-4)
    assert sorted(ga) == sorted(wa)
    for k in wa:
        np.testing.assert_allclose(float(ga[k]), float(wa[k]), rtol=1e-4, atol=1e-6)


def test_pretrain_head_builder_shapes():
    """`bridge.py` builds the JAX trees' shapes, and `params_from_numpy`
    carries a JAX pre-training head across leaf for leaf."""
    from omni_avsr_tpu.models.avhubert import init_avhubert as jinit
    from omni_avsr_tpu.models.avhubert_pretrain import init_pretrain_head as jhead
    from omni_avsr_tpu_torch.bridge import params_from_numpy

    jh = jax.device_get(jhead(jax.random.PRNGKey(1), JCfg(**KW), 6, 16))
    th = params_from_numpy(jh, "cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(jh):
        got = th
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(got.numpy(), leaf)
    g = torch.Generator().manual_seed(0)
    shapes = lambda tree: jax.tree_util.tree_map(lambda x: tuple(x.shape), tree)  # noqa: E731
    assert shapes(init_pretrain_head(PCfg(**KW), 6, 16, g, "cpu")) == shapes(
        jax.eval_shape(lambda k: jhead(k, JCfg(**KW), 6, 16), jax.random.PRNGKey(0)))
    assert shapes(init_avhubert(PCfg(**KW), g, "cpu")) == shapes(
        jax.eval_shape(lambda k: jinit(k, JCfg(**KW)), jax.random.PRNGKey(0)))


def test_mfcc_and_kmeans_equal_jax():
    from omni_avsr_tpu.cli import cluster_units as jc
    from omni_avsr_tpu_torch.cli import cluster_units as pc

    audio = (np.random.RandomState(2).randn(8000) * 0.1).astype(np.float32)
    np.testing.assert_array_equal(pc.mfcc(audio), jc.mfcc(audio))
    np.testing.assert_array_equal(pc.mfcc(audio[:300], with_deltas=False),
                                  jc.mfcc(audio[:300], with_deltas=False))
    rng = np.random.RandomState(1)
    feats = np.concatenate([rng.randn(300, 4) + 6, rng.randn(300, 4) - 6,
                            rng.randn(200, 4)]).astype(np.float32)
    C = pc.kmeans_fit(feats, 3, iters=4, seed=2, batch=256)
    np.testing.assert_array_equal(C, jc.kmeans_fit(feats, 3, iters=4, seed=2, batch=256))
    np.testing.assert_array_equal(pc.kmeans_assign(feats, C), jc.kmeans_assign(feats, C))


@pytest.mark.parametrize("layer", [0, 2])
def test_layer_reader_matches_jax_encode(enc, tmp_path, layer):
    """cluster_units' layer-N dump from a checkpoint in the port's format
    (what `pretrain_avhubert` saves), against the JAX encode of the same
    clip, padded to 32 frames and masked to its length."""
    from omni_avsr_tpu.data.audio_features import stacked_fbank
    from omni_avsr_tpu.models.avhubert import avhubert_encode as jencode
    from omni_avsr_tpu.ops.augment import video_pipeline as jpipe
    from omni_avsr_tpu_torch.cli.cluster_units import make_avhubert_reader
    from omni_avsr_tpu_torch.train.checkpoint import save_checkpoint
    from omni_avsr_tpu_torch.train.state import TrainState

    jp, tp = enc[:2]
    ckpt = save_checkpoint(str(tmp_path / "checkpoints"), 1,
                           TrainState(1, {"enc": tp, "head": enc[3]}, None))
    (tmp_path / "config.json").write_text(json.dumps({"avhubert": KW}))
    rng = np.random.RandomState(6)
    frames = 21
    video = rng.randint(0, 255, (frames, 96, 96, 3)).astype(np.uint8)
    audio = (rng.randn(frames * 640) * 0.1).astype(np.float32)
    got = make_avhubert_reader(ckpt, str(tmp_path / "config.json"), layer, "cpu")(video, audio)
    vid = np.zeros((1, 32, 96, 96, 3), np.uint8)
    vid[0, :frames] = video
    lens = jnp.asarray([frames], jnp.int32)
    v = jpipe(None, jnp.asarray(vid), lens, train=False)
    want = np.asarray(jencode(jp, JCfg(**KW), v, jnp.asarray(stacked_fbank(audio, 32)[None]),
                              lens, output_layer=layer))[0, :frames]
    assert got.shape == (frames, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOWER_TOL)
