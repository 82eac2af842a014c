"""The work counts of `work/omni.py` against hand counts and against the
FLOPs torch's counter sees in the plain reference, at tiny shapes."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import weights
from portbench.reference import omni as ref
from portbench.work.omni import OmniWork, bound_s, resnet_flops_per_frame

from . import tiny


def test_bound_by_hand():
    # M 1, K = N = 1024: 1 MiB of codes, 4 KiB of scales, 2 KiB in, 2 KiB out
    assert bound_s(1, 1024, 1024) == pytest.approx((1024 * 1024 + 4096 + 2048 + 2048) / 3.35e12)
    # M 4096: compute-bound, 2 * 4096 * 1024 * 1024 FLOPs at 989 TFLOP/s
    assert bound_s(4096, 1024, 1024) == pytest.approx(2 * 4096 * 1024 * 1024 / 989e12)
    assert bound_s(0, 8, 8) == 0.0


def _counted(fn, *args):
    with FlopCounterMode(display=False) as c:
        fn(*args)
    return c.get_total_flops()


@pytest.fixture(scope="module")
def cfg():
    return tiny.config()


@pytest.fixture(scope="module")
def w(cfg):
    return ref.Weights(weights.draw(cfg, 1, "cpu", torch.float32), None)


def test_resnet_per_frame(w):
    frames = torch.zeros(3, 88, 88)
    assert _counted(ref.resnet, w, frames) == pytest.approx(3 * resnet_flops_per_frame())


def test_towers_against_the_reference(cfg, w):
    work = OmniWork(cfg)
    frames = 20  # 0.8 s: 40 Whisper tokens, 80 mel frames
    t = ref.whisper_tokens(frames * 640)
    mel = torch.zeros(2 * t, 80)
    D, I, h = cfg["whisper"]["hidden_size"], cfg["projector"]["intermediate_size"], 64
    tower = (work.call("audio", [frames], 1, 0)["flops"] - _decoder(work, "audio", frames)
             - 2.0 * (t // 4) * (D * I + I * h))
    assert _counted(ref.whisper, w, cfg, mel) == pytest.approx(tower)
    v = torch.zeros(frames, 88, 88)
    E = cfg["avhubert"]["encoder_embed_dim"]
    a = cfg["avhubert"]
    tower = (work.call("video", [frames], 1, 0)["flops"] - _decoder(work, "video", frames)
             - 2.0 * (frames // 2) * (E * I + I * h))
    extra = 2.0 * E * (E // a["conv_pos_groups"]) * a["conv_pos"]  # the conv's one trimmed output
    assert _counted(ref.avhubert, w, cfg, v) == pytest.approx(tower + extra)


def _decoder(work, modality, frames):
    """The decoder's share of a call with no decode step, by hand."""
    p = work.prefix_tokens(modality, frames)
    lin = sum(k * n for k, n in work.llm_mats()) + work.lora_params()
    return (2.0 * p * lin * work.L + work.L * 4.0 * work.nh * work.hd * p * (p + 1) / 2
            + 2.0 * work.h * work.V)


def test_decoder_by_hand(cfg):
    work = OmniWork(cfg)
    h, ffn, L, V = 64, 128, 2, 300
    nh, nkv, hd, r, v_out = 4, 2, 16, 8, 32
    lin = h * nh * hd + 2 * h * nkv * hd + nh * hd * h + 3 * h * ffn
    lora = 2 * h * r + r * h + r * v_out
    assert work.llm_mats() and sum(k * n for k, n in work.llm_mats()) == lin
    assert work.lora_params() == lora
    p = work.prefix_tokens("video", 20)  # 2 delimiters + 10 video tokens + 4 prompt words
    assert p == 16
    B, K, steps = 2, 3, 2
    a = work.call("video", [20, 20], K, steps)
    b = work.call("video", [20, 20], K, 0)
    R = B * K
    step_flops = sum(2.0 * R * (lin + lora) * L + 2.0 * R * h * V
                     + L * 4.0 * nh * hd * K * B * (p + t + 1) for t in range(steps))
    assert a["flops"] - b["flops"] == pytest.approx(step_flops)
    kv = nkv * hd * 2 * 2
    assert a["beam_attn_bytes"] == pytest.approx(sum(
        L * (B * p * kv + R * (t + 1) * kv + 2 * R * nh * hd * 2) for t in range(steps)))
    decode_mkn = a["int8"][len(b["int8"]):]
    assert len(decode_mkn) == steps * (7 * L + 1) and all(m == R for m, _, _ in decode_mkn)
