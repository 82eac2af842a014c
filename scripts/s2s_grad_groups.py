#!/usr/bin/env python3
"""Where the bf16 rounding of one full-width AV-HuBERT seq2seq train step
lands: chip_smoke.py (l)'s step (B 4 x 320 frames, audiovisual, 64-token
targets, remat "off") three ways from one tree and one key: in bf16
through B3/B4, in bf16 through their plain versions, and in f32 through
the plain versions. Prints the grads' relative L2 distance between each
pair, over every leaf and by group (the ResNet trunk, the encoder layers,
the encoder's other leaves, the decoder layers, the decoder's other
leaves), and the ten leaves that differ most between the two bf16 routes:

    python3 scripts/s2s_grad_groups.py
"""

import contextlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def group(name: str) -> str:
    if name.startswith("enc.video_frontend"):
        return "resnet"
    if name.startswith("enc.layers"):
        return "enc.layers"
    if name.startswith("enc."):
        return "enc.other"
    return "dec.layers" if name.startswith("head.layers") else "dec.other"


def paths(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from paths(v, f"{prefix}{k}.")
        else:
            yield prefix + k


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from omni_avsr_tpu_torch.bridge import init_avhubert, init_s2s_decoder
    from omni_avsr_tpu_torch.cli.train_avhubert_s2s import S2STrainer
    from omni_avsr_tpu_torch.config import avhubert_large
    from omni_avsr_tpu_torch.data.audio_features import batch_stacked_fbank
    from omni_avsr_tpu_torch.models.avhubert_s2s import S2SDecoderConfig
    from omni_avsr_tpu_torch.utils import prng

    if not torch.cuda.is_available():
        print("s2s_grad_groups: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, B, F = "cuda", cs.B_TRAIN, cs.FRAMES_TRAIN
    enc_cfg, dec_cfg = avhubert_large(use_lora=False), S2SDecoderConfig()
    video_np, audio_np = cs.av_clips(B, F, seed=5)
    afeats = torch.from_numpy(batch_stacked_fbank(audio_np, np.full(B, F * 640), F)).to(dev)
    video = torch.from_numpy(video_np).to(dev)
    video_len = torch.full((B,), F, dtype=torch.int32, device=dev)
    tgt = np.random.RandomState(6).randint(4, dec_cfg.vocab_size, (B, cs.S2S_TOKENS))
    tgt[:, -1] = dec_cfg.eos_id
    tgt = torch.from_numpy(tgt.astype(np.int32)).to(dev)
    tgt_len = torch.full((B,), cs.S2S_TOKENS, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {"enc": init_avhubert(enc_cfg, gen, dev), "head": init_s2s_decoder(dec_cfg, gen, dev)}
    names = list(paths(params))
    groups = {}
    for i, n in enumerate(names):
        groups.setdefault(group(n), []).append(i)
    groups["all"] = list(range(len(names)))
    key = prng.fold_in(prng.PRNGKey(17), 99)
    res = {}
    for label, dtype, plain in (("kernel", torch.bfloat16, False),
                                ("plain", torch.bfloat16, True),
                                ("plain_f32", torch.float32, True)):
        trainer = S2STrainer(enc_cfg, dec_cfg, "s2s", params, 1e-4, 1, False, dev, dtype=dtype,
                             remat="off")
        with cs.plain_train_route() if plain else contextlib.nullcontext():
            loss, grads = trainer.loss_and_grads(video, afeats, video_len, tgt, tgt_len, key)
        res[label] = (float(loss), [g.float() for g in grads])
        del trainer
        torch.cuda.empty_cache()

    def rel(a, b, idx):
        num = sum(((a[i] - b[i]) ** 2).sum() for i in idx)
        den = sum((b[i] ** 2).sum() for i in idx)
        return float((num / den).sqrt())

    for x, y in (("kernel", "plain"), ("plain", "plain_f32"), ("kernel", "plain_f32")):
        a, b = res[x][1], res[y][1]
        print(json.dumps({"pair": [x, y], "losses": [res[x][0], res[y][0]],
                          "rel_l2": {g: rel(a, b, idx) for g, idx in groups.items()}}))
    a, b = res["kernel"][1], res["plain"][1]
    worst = sorted(((float((a[i] - b[i]).norm()), names[i]) for i in groups["all"]),
                   reverse=True)[:10]
    print(json.dumps({"worst_leaves_kernel_vs_plain": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
