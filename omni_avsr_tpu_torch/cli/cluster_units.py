"""HuBERT unit discovery: MFCC or trained-encoder features, then k-means
(port of `omni_avsr_tpu/cli/cluster_units.py`; reference
`av_hubert/avhubert/clustering/*.py`):

  # iteration 1: MFCC units at 100 Hz
  python -m omni_avsr_tpu_torch.cli.cluster_units \\
      --root-dir data/ --manifest train.csv --out-dir units/ --n-clusters 100

  # iterations 2-5: layer-N features of an AV-HuBERT the port pre-trained
  # (`clustering/dump_hubert_feature.py:32-134`) at 25 Hz
  python -m omni_avsr_tpu_torch.cli.cluster_units \\
      --root-dir data/ --manifest train.csv --out-dir units2/ \\
      --features avhubert --layer 12 --ckpt exp_pretrain/checkpoints/step_00000100.pt

Writes `<out>/kmeans.npy` (centroids), `<out>/label_rate.txt` (Hz) and
`<out>/labels/<clip>.km` (space-separated unit ids per feature frame), the
pre-training targets of `cli/pretrain_avhubert.py`. The MFCCs and the
k-means run on the host in numpy, as in the JAX package; the layer-N dump
runs the encoder on `--device` (the card unless given cpu). `--ckpt` is a
checkpoint of the port's own `pretrain_avhubert` (`torch.save`); the JAX
package's orbax checkpoints are not read.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import List, Tuple

import numpy as np
import torch

from ..data.dataset import load_audio, load_manifest
from ..ops.audio_frontend import mel_filter_bank


def mfcc(audio: np.ndarray, sr: int = 16000, n_mfcc: int = 13,
         with_deltas: bool = True) -> np.ndarray:
    """(S,) -> (T, 13|39) MFCCs at 25 ms / 10 ms with optional deltas."""
    n_fft, hop = 400, 160
    if len(audio) < n_fft:
        audio = np.pad(audio, (0, n_fft - len(audio)))
    n_frames = 1 + (len(audio) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    frames = audio[idx] * window
    power = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    fb = mel_filter_bank()  # (201, 80)
    mel = np.maximum(power @ fb, 1e-10)
    logmel = np.log(mel)
    # DCT-II orthonormal, first n_mfcc coefficients
    M = logmel.shape[1]
    k = np.arange(n_mfcc)[:, None]
    n = np.arange(M)[None, :]
    dct = np.cos(np.pi * k * (2 * n + 1) / (2 * M)) * np.sqrt(2.0 / M)
    dct[0] /= np.sqrt(2.0)
    feats = logmel @ dct.T  # (T, 13)
    if with_deltas:
        d1 = np.gradient(feats, axis=0)
        d2 = np.gradient(d1, axis=0)
        feats = np.concatenate([feats, d1, d2], axis=1)
    return feats.astype(np.float32)


def kmeans_fit(feats: np.ndarray, k: int, iters: int = 20, seed: int = 0,
               batch: int = 65536) -> np.ndarray:
    """Mini-batch k-means with k-means++ init. Returns (k, D) centroids."""
    rng = np.random.RandomState(seed)
    n = len(feats)
    # k-means++ seeding on a subsample
    sub = feats[rng.choice(n, min(n, 20000), replace=False)]
    centroids = [sub[rng.randint(len(sub))]]
    for _ in range(1, k):
        d2 = np.min(((sub[:, None] - np.stack(centroids)[None]) ** 2).sum(-1), axis=1)
        probs = d2 / max(d2.sum(), 1e-12)
        centroids.append(sub[rng.choice(len(sub), p=probs)])
    C = np.stack(centroids)
    counts = np.zeros(k)
    for _ in range(iters):
        bi = rng.choice(n, min(batch, n), replace=False)
        x = feats[bi]
        assign = np.argmin((x ** 2).sum(1)[:, None] - 2 * x @ C.T + (C ** 2).sum(1)[None],
                           axis=1)
        for j in np.unique(assign):
            sel = x[assign == j]
            counts[j] += len(sel)
            lr = len(sel) / counts[j]
            C[j] = (1 - lr) * C[j] + lr * sel.mean(axis=0)
    return C.astype(np.float32)


def kmeans_assign(feats: np.ndarray, C: np.ndarray) -> np.ndarray:
    return np.argmin(
        (feats ** 2).sum(1)[:, None] - 2 * feats @ C.T + (C ** 2).sum(1)[None], axis=1,
    ).astype(np.int32)


def make_avhubert_reader(ckpt: str, config: str, layer: int, device="cuda"):
    """Layer-N AV-HuBERT feature dump (`dump_hubert_feature.py:32-106`
    semantics): eval-mode transforms (CenterCrop 88 and normalise the video,
    stacked log filterbanks for the audio), both modalities fed, no
    masking, stop at layer N (0: the fused features). One clip at a time on
    `device`, its length padded up to a multiple of 32 frames as the JAX
    reader buckets it, the encoder in bf16 on the card (the flash kernel
    B3 takes bf16) and f32 on the CPU; `lengths` masks the padding.
    Returns reader(video_u8 (T, H, W, C), audio (S,)) -> (T, D) f32."""
    from ..config import AVHubertConfig
    from ..data.audio_features import stacked_fbank
    from ..models.avhubert import avhubert_encode
    from ..ops.augment import video_pipeline
    from ..train.checkpoint import resolve_checkpoint, restore_trainable
    from ..train.state import tree_map

    device = torch.device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    with open(config) as f:
        cfg_dict = json.load(f)["avhubert"]
    names = {f.name for f in dataclasses.fields(AVHubertConfig)}
    cfg = AVHubertConfig(**{k: v for k, v in cfg_dict.items() if k in names})
    tree = restore_trainable(resolve_checkpoint(ckpt), device)
    enc = tree_map(lambda x: x.detach().to(dtype), tree.get("enc", tree))

    @torch.no_grad()
    def reader(video_u8: np.ndarray, audio: np.ndarray) -> np.ndarray:
        T = len(video_u8)
        Tp = ((T + 31) // 32) * 32  # the JAX reader's static bucket
        vid = np.zeros((1, Tp) + video_u8.shape[1:], video_u8.dtype)
        vid[0, :T] = video_u8
        afe = stacked_fbank(audio, Tp)[None]
        lengths = torch.tensor([T], dtype=torch.int32, device=device)
        v = video_pipeline(torch.from_numpy(vid).to(device), lengths, train=False)
        out = avhubert_encode(enc, cfg, v.to(dtype), audio=torch.from_numpy(afe).to(device, dtype),
                              lengths=lengths, output_layer=layer)
        return out[0, :T].float().cpu().numpy()

    return reader


def main(argv=None):
    p = argparse.ArgumentParser("cluster_units")
    p.add_argument("--root-dir", required=True)
    p.add_argument("--manifest", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--n-clusters", type=int, default=100)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--max-feats", type=int, default=2_000_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--features", choices=("mfcc", "avhubert"), default="mfcc",
                   help="mfcc = iteration 1; avhubert = layer-N features of a trained encoder "
                        "(iterations 2-5)")
    p.add_argument("--layer", type=int, default=12,
                   help="1-based encoder layer for --features avhubert (0 = conv/fused "
                        "features, ret_conv)")
    p.add_argument("--ckpt", default=None,
                   help="a checkpoint (step_*.pt, or its directory) saved by the port's "
                        "cli/pretrain_avhubert")
    p.add_argument("--config", default=None,
                   help="config.json from the pretrain exp dir (default: ../../config.json "
                        "relative to the --ckpt file)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the --features avhubert dump; without a CUDA device "
                        "the CLI stops unless given cpu")
    args = p.parse_args(argv)

    entries = load_manifest(args.manifest)
    os.makedirs(os.path.join(args.out_dir, "labels"), exist_ok=True)

    if args.features == "avhubert":
        from .common import check_args

        if not args.ckpt:
            raise SystemExit("--features avhubert requires --ckpt")
        from ..train.checkpoint import resolve_checkpoint

        device = check_args(args)
        ckpt = resolve_checkpoint(args.ckpt)  # a directory -> its newest step_*.pt
        config = args.config or os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(ckpt))), "config.json")
        reader = make_avhubert_reader(ckpt, config, args.layer, device)
        from ..data.dataset import load_video

        def featurize(e):
            path = e.path(args.root_dir)
            return reader(load_video(path), load_audio(path))

        label_rate = 25  # encoder features are video-aligned
    else:
        def featurize(e):
            return mfcc(load_audio(e.path(args.root_dir)))

        label_rate = 100
    with open(os.path.join(args.out_dir, "label_rate.txt"), "w") as f:
        f.write(str(label_rate))

    all_feats: List[np.ndarray] = []
    per_clip: List[Tuple[str, np.ndarray]] = []
    total = 0
    for e in entries:
        f = featurize(e)
        per_clip.append((os.path.splitext(os.path.basename(e.rel_path))[0], f))
        if total < args.max_feats:
            all_feats.append(f)
            total += len(f)
    feats = np.concatenate(all_feats)[: args.max_feats]
    print(f"fitting k-means: {len(feats)} frames, k={args.n_clusters}")
    C = kmeans_fit(feats, args.n_clusters, args.iters, args.seed)
    np.save(os.path.join(args.out_dir, "kmeans.npy"), C)

    for name, f in per_clip:
        labels = kmeans_assign(f, C)
        with open(os.path.join(args.out_dir, "labels", name + ".km"), "w") as out:
            out.write(" ".join(map(str, labels.tolist())))
    print(f"wrote {len(per_clip)} label files to {args.out_dir}/labels")


if __name__ == "__main__":
    main()
