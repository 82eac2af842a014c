"""Random weights of an Omni-AVSR configuration, drawn from the run's seed.

The tree has the layout the port's serving API takes (nested dicts; a
linear is {"w": (in, out)[, "b"]}, stacked layers carry a leading (L, ...)
axis, convs are channel-last). Every leaf is `base + std * z` with z drawn
from one `torch.Generator` on the target device, in two large draws:

  - group "mats": the matrices the serving tree quantises (the LLM's
    attention and MLP weights, its lm_head, the towers' layer matrices);
    the program replaces them by int8 codes, so this buffer is freed once
    the serving tree is built;
  - group "kept": everything else (embeddings, norms, biases, LoRA,
    projectors, convs, BatchNorm statistics).

The same seed gives the same tree, so the plain reference draws it again
after the measured window instead of keeping a copy on the card.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

MODALITIES = ("audio", "video", "audiovisual")

Spec = Tuple[Tuple[str, ...], Tuple[int, ...], float, float, str]  # path, shape, base, std, group


def whisper_positions(length: int, channels: int) -> np.ndarray:
    """Whisper's sinusoid table: log-spaced timescales, [sin | cos]."""
    inc = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1)


def layout(cfg: dict) -> List[Spec]:
    """Every leaf of the configuration's tree, in a fixed order."""
    specs: List[Spec] = []

    def add(path, shape, base=0.0, std=0.0, group="kept"):
        specs.append((tuple(path.split(".")), tuple(shape), float(base), float(std), group))

    def linear(path, lead, i, o, bias=True, group="mats", std=None):
        add(f"{path}.w", (*lead, i, o), 0.0, std if std is not None else i ** -0.5, group)
        if bias:
            add(f"{path}.b", (*lead, o), 0.0, 0.02)

    def norm(path, lead, d, bias=True):
        add(f"{path}.scale", (*lead, d), 1.0, 0.05)
        if bias:
            add(f"{path}.bias", (*lead, d), 0.0, 0.02)

    h, ffn, L = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = h // nh
    V = cfg["vocab_size"]
    lora = cfg["lora"]
    r = int(round(h / lora["rank_divisor"]))
    v_out = h // lora["v_out_divisor"]
    ll = (L,)
    if not cfg["tie_word_embeddings"]:
        add("llm.lm_head.w", (h, V), 0.0, h ** -0.5, "mats")
    add("llm.embed.w", (V, h), 0.0, 1.0)
    add("llm.final_norm.scale", (h,), 1.0, 0.05)
    norm("llm.layers.input_norm", ll, h, bias=False)
    norm("llm.layers.post_attn_norm", ll, h, bias=False)
    linear("llm.layers.attn.q", ll, h, nh * hd)
    linear("llm.layers.attn.k", ll, h, nkv * hd)
    linear("llm.layers.attn.v", ll, h, nkv * hd)
    linear("llm.layers.attn.o", ll, nh * hd, h, bias=False)
    linear("llm.layers.mlp.gate", ll, h, ffn, bias=False)
    linear("llm.layers.mlp.up", ll, h, ffn, bias=False)
    linear("llm.layers.mlp.down", ll, ffn, h, bias=False)
    for m in MODALITIES:  # task-specific Omni-LoRA (q and v)
        linear(f"llm.layers.lora.{m}.down_q", ll, h, r, bias=False, group="kept")
        linear(f"llm.layers.lora.{m}.up_q", ll, r, h, bias=False, group="kept", std=0.5 * r ** -0.5)
        linear(f"llm.layers.lora.{m}.down_v", ll, h, r, bias=False, group="kept")
        linear(f"llm.layers.lora.{m}.up_v", ll, r, v_out, bias=False, group="kept",
               std=0.5 * r ** -0.5)

    w = cfg["whisper"]
    D, wl = w["hidden_size"], (w["num_layers"],)
    add("whisper.conv1.w", (3, w["num_mel_bins"], D), 0.0, (3 * w["num_mel_bins"]) ** -0.5)
    add("whisper.conv1.b", (D,), 0.0, 0.02)
    add("whisper.conv2.w", (3, D, D), 0.0, (3 * D) ** -0.5)
    add("whisper.conv2.b", (D,), 0.0, 0.02)
    specs.append((("whisper", "pos_embed"), (w["max_source_positions"], D), 0.0, 0.0, "table"))
    norm("whisper.layers.attn_norm", wl, D)
    linear("whisper.layers.attn.q", wl, D, D)
    linear("whisper.layers.attn.k", wl, D, D, bias=False)
    linear("whisper.layers.attn.v", wl, D, D)
    linear("whisper.layers.attn.o", wl, D, D)
    norm("whisper.layers.mlp_norm", wl, D)
    linear("whisper.layers.fc1", wl, D, w["ffn_dim"])
    linear("whisper.layers.fc2", wl, w["ffn_dim"], D)
    norm("whisper.final_norm", (), D)

    a = cfg["avhubert"]
    E, al = a["encoder_embed_dim"], (a["encoder_layers"],)
    _resnet(add, "avhubert.video_frontend")
    linear("avhubert.video_proj", (), 512, E, group="kept")
    linear("avhubert.audio_proj", (), a["audio_feat_dim"], E, group="kept")
    norm("avhubert.fuse_norm", (), 2 * E)
    linear("avhubert.post_extract_proj", (), 2 * E, E, group="kept")
    k, g = a["conv_pos"], a["conv_pos_groups"]
    add("avhubert.pos_conv.w", (k, E // g, E), 0.0, (4.0 / (k * E)) ** 0.5)
    add("avhubert.pos_conv.b", (E,), 0.0, 0.02)
    norm("avhubert.layers.attn_norm", al, E)
    for n in ("q", "k", "v", "o"):
        linear(f"avhubert.layers.attn.{n}", al, E, E)
    norm("avhubert.layers.final_norm", al, E)
    linear("avhubert.layers.fc1", al, E, a["encoder_ffn_dim"])
    linear("avhubert.layers.fc2", al, a["encoder_ffn_dim"], E)
    ra = int(round(E / a["lora_rank_divisor"]))
    linear("avhubert.layers.lora.down_q", al, E, ra, bias=False, group="kept")
    linear("avhubert.layers.lora.up_q", al, ra, E, bias=False, group="kept", std=0.1 * ra ** -0.5)
    linear("avhubert.layers.lora.down_v", al, E, ra, bias=False, group="kept")
    linear("avhubert.layers.lora.up_v", al, ra, E, bias=False, group="kept", std=0.1 * ra ** -0.5)
    norm("avhubert.top_norm", (), E)

    p = cfg["projector"]
    for mod, enc, rates in (("audio_proj", D, p["rates_audio"]), ("video_proj", E, p["rates_video"])):
        for rate in rates:
            linear(f"{mod}.per_rate.r{rate}.fc1", (), enc, p["intermediate_size"], group="kept")
            linear(f"{mod}.per_rate.r{rate}.fc2", (), p["intermediate_size"], h, group="kept")
    return specs


def _resnet(add, prefix: str) -> None:
    """ResNet-18 video frontend with a 3D stem, PReLU (AV-HuBERT's ResEncoder)."""

    def conv(path, kh, kw, cin, cout):
        add(f"{path}.w", (kh, kw, cin, cout), 0.0, math.sqrt(2.0 / (kh * kw * cin)))

    def bn(path, c):
        add(f"{path}.scale", (c,), 1.0, 0.1)
        add(f"{path}.bias", (c,), 0.0, 0.1)
        add(f"{path}.mean", (c,), 0.0, 0.1)
        add(f"{path}.var", (c,), 1.0, 0.1)

    add(f"{prefix}.stem.conv.w", (5, 7, 7, 1, 64), 0.0, math.sqrt(2.0 / (5 * 7 * 7)))
    bn(f"{prefix}.stem.bn", 64)
    add(f"{prefix}.stem.prelu", (64,), 0.25, 0.02)
    cin = 64
    for li, cout in enumerate((64, 128, 256, 512), start=1):
        for b in (0, 1):
            path = f"{prefix}.layer{li}.b{b}"
            ci = cin if b == 0 else cout
            conv(f"{path}.conv1", 3, 3, ci, cout)
            bn(f"{path}.bn1", cout)
            conv(f"{path}.conv2", 3, 3, cout, cout)
            bn(f"{path}.bn2", cout)
            add(f"{path}.prelu1", (cout,), 0.25, 0.02)
            add(f"{path}.prelu2", (cout,), 0.25, 0.02)
            if b == 0 and li > 1:
                conv(f"{path}.downsample.conv", 1, 1, ci, cout)
                bn(f"{path}.downsample.bn", cout)
        cin = cout


def _numel(shape) -> int:
    return int(np.prod(shape)) if shape else 1


def draw(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The configuration's tree on `device` in `dtype`, from `seed`: one
    normal draw per group, each leaf a view of its group's buffer shifted
    and scaled in place. BatchNorm variances are kept positive."""
    specs = layout(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    tree: Dict = {}
    for group in ("mats", "kept"):
        members = [s for s in specs if s[4] == group]
        total = sum(_numel(s[1]) for s in members)
        buf = torch.empty(total, dtype=dtype, device=device)
        buf.normal_(0.0, 1.0, generator=gen)
        off = 0
        for path, shape, base, std, _ in members:
            n = _numel(shape)
            leaf = buf[off:off + n].view(shape)
            off += n
            if std == 0.0:
                leaf.fill_(base)
            else:
                leaf.mul_(std).add_(base)
            if path[-1] == "var":
                leaf.clamp_(min=0.1)
            _put(tree, path, leaf)
    for path, shape, _, _, group in specs:
        if group == "table":
            _put(tree, path, torch.from_numpy(whisper_positions(*shape)).to(device=device,
                                                                            dtype=dtype))
    return tree


def _put(tree: Dict, path: Tuple[str, ...], leaf) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = leaf
