"""The plain reference against the port, at tiny widths on the CPU, in
float32: the same prefix embeddings and the same decoder log-probabilities
for each modality, at the window the serving API pads to."""

from __future__ import annotations

import pytest
import torch

from portbench import media, weights
from portbench.check import request_windows, served_tokens
from portbench.reference import omni as ref
from portbench.systems.omni_transcriber import System

from . import tiny


@pytest.fixture(scope="module")
def cfg():
    return tiny.config()


def _requests(modality, frames, beams=1):
    reqs = [media.Req(i, modality, beams, f) for i, f in enumerate(frames)]
    media.fill_media(reqs, 3, "cpu")
    return reqs


def _served(system, reqs, modality, beams):
    for r in reqs:
        system.tag(r.rid, r.item)
    system.serve([r.item for r in reqs], modality, beams)
    return request_windows(system.calls, {r.rid: r for r in reqs},
                           system.cfg["serving"]["video_pad_multiple"])


@pytest.mark.parametrize("modality", ["audiovisual", "audio", "video"])
@pytest.mark.parametrize("bits", [None, 8])
def test_reference_follows_the_port(cfg, modality, bits):
    """Greedy ids of the f32 port (unquantised, or int8 on the plain
    matmul) lie at the reference's best to float32 rounding, and the
    reference's prefix equals the port's valid prefix slots."""
    torch.manual_seed(0)
    system = System(cfg, 21, "cpu", quantize="int8" if bits else "", dtype=torch.float32)
    reqs = _requests(modality, [17, 9, 30])
    wins = _served(system, reqs, modality, 1)
    model = ref.Reference(cfg, weights.draw(cfg, 21, "cpu", torch.float32), bits, "cpu")
    rr = []
    for r in reqs:
        toks, ended = served_tokens(system.served[r.rid], model.vocab.eos)
        rr.append(ref.Request(r.item.get("audio"), r.item.get("video"), modality, wins[r.rid],
                              toks + ([model.vocab.eos] if ended else [])))
    for r, lp in zip(rr, model.logprobs(rr)):
        toks = torch.as_tensor(r.served)
        got = lp[torch.arange(len(toks)), toks]
        assert (lp[: len(toks)].max(-1).values - got).max().item() < 1e-4

    # the prefix itself, against the port's masked prefix (its valid slots)
    from omni_avsr_tpu_torch.ops.augment import audio_pipeline, video_pipeline
    from omni_avsr_tpu_torch.serve import pad_batch

    batch, trim = pad_batch([r.item for r in reqs], modality, 32)
    arrays = {k: torch.as_tensor(v) for k, v in batch.items()}
    if "video" in arrays:
        arrays["video"] = video_pipeline(arrays["video"], arrays["video_len"])
    if "audio" in arrays:
        arrays["audio"] = audio_pipeline(arrays["audio"], arrays["audio_len"])
    with torch.no_grad():
        prefix, valid = system.model.infer_prefix_masked(system.t.params, arrays, modality, 4, 2,
                                                         trim)
        for b, r in enumerate(rr):
            mine = model.prefix(r)
            theirs = prefix[b][valid[b]].float()
            assert mine.shape == theirs.shape
            rel = ((mine - theirs).norm() / theirs.norm()).item()
            assert rel < (1e-5 if bits is None else 1e-4), rel


def test_window_rule(cfg):
    """The reference's window is the serving API's padding rule."""
    from omni_avsr_tpu_torch.serve import pad_batch

    for modality in ("audiovisual", "audio", "video"):
        for frames in ([17, 9], [33], [97, 10], [200]):
            reqs = _requests(modality, frames)
            batch, trim = pad_batch([r.item for r in reqs], modality, 32)
            w = ref.batch_window(frames, [f * 640 for f in frames], modality)
            if modality != "audio":
                assert w.frames == batch["video"].shape[1]
            if modality != "video":
                assert (w.samples, w.trim) == (batch["audio"].shape[1], trim)


def test_layout_is_the_ports(cfg):
    """The drawn tree has the port's leaves and shapes (`bridge.init_params`
    of the same configuration)."""
    from omni_avsr_tpu_torch.bridge import init_params
    from omni_avsr_tpu_torch.models.common import tree_paths
    from portbench.systems.omni_transcriber import omni_config

    theirs = init_params(omni_config(cfg), torch.Generator().manual_seed(0), "cpu")
    mine = weights.draw(cfg, 0, "cpu")
    assert ({p: tuple(v.shape) for p, v in tree_paths(mine)}
            == {p: tuple(v.shape) for p, v in tree_paths(theirs)})
