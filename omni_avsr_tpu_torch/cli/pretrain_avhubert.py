"""AV-HuBERT masked-prediction pre-training (port of
`omni_avsr_tpu/cli/pretrain_avhubert.py`; fairseq's `av_hubert_pretraining`
task with AVHubertCriterion).

It closes the unit-discovery loop: it reads the `.km` unit labels that
`cli/cluster_units.py` writes (or, without `--labels-dir`, quick targets
made from the audio), trains the encoder and the pre-training head with
`models/avhubert_pretrain.py`'s loss, and saves them in the port's
checkpoint format (`train/checkpoint.py`, `torch.save`) with a
`config.json` beside, which `cluster_units --features avhubert --ckpt`
reads for the next iteration. The port reads its own pre-training
checkpoints, not the JAX package's orbax ones.

The step is the JAX CLI's: the pre-training video pipeline (crop and flip,
no time mask) and the span mask under threefry keys (`fold_in(PRNGKey(seed),
step)`, then `kv, kp = split(key)`: bit-equal draws), the ResNet in eval
mode, the encoder without dropout, and the optimizer of `train/optim.py`
over `--max-steps`. The masters are f32; on the card the step computes in
bf16 (the flash kernels take bf16), on the CPU in f32.

  python -m omni_avsr_tpu_torch.cli.pretrain_avhubert --synthetic 4 \\
      --max-steps 8 --exp-dir /tmp/pretrain_smoke [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import AVHubertConfig, TrainConfig
from ..models.avhubert_pretrain import avhubert_pretrain_loss
from ..models.common import Params, linear
from ..models.resnet3d import resnet3d_forward
from ..ops.augment import pretrain_video_pipeline
from ..train.optim import make_optimizer
from ..train.state import TrainState, master_weights, tree_leaves, tree_map
from ..utils import prng
from .common import check_args, read_numerics, str2bool


def labels_rate(labels_dir: str) -> int:
    """Unit-label frame rate: 100 Hz for MFCC units (iteration 1), 25 Hz for
    AV-HuBERT layer features (iterations 2-5). cluster_units records it."""
    path = os.path.join(labels_dir, "label_rate.txt")
    if os.path.exists(path):
        return int(open(path).read().strip())
    return 100


def load_unit_labels(labels_dir: str, name: str, T: int, n_units: int,
                     rate: int = 100) -> np.ndarray:
    """A clip's (T,) unit ids at the video's 25 Hz (100 Hz labels taken
    every 4th), zero past the file's end, clipped to the unit range."""
    path = os.path.join(labels_dir, name + ".km")
    if os.path.exists(path):
        ids = np.asarray(open(path).read().split(), np.int32)
        step = max(rate // 25, 1)
        ids = ids[::step][:T]
    else:
        ids = np.zeros(0, np.int32)
    out = np.zeros(T, np.int32)
    out[: len(ids)] = ids[:T]
    return np.clip(out, 0, n_units - 1)


def demo_targets(audio: np.ndarray, T: int, n_units: int) -> np.ndarray:
    """(B, T) quick targets from the padded (B, T * 640) audio: each
    frame's mean magnitude binned into the units (the demo and smoke path)."""
    return np.clip((np.abs(audio).reshape(len(audio), T, 640).mean(-1)
                    * n_units * 10).astype(np.int32), 0, n_units - 1)


def pretrain_config(tiny: bool) -> AVHubertConfig:
    if tiny:
        return AVHubertConfig(encoder_embed_dim=48, encoder_layers=2, encoder_heads=4,
                              encoder_ffn_dim=96, audio_feat_dim=104, lora_rank_divisor=None)
    from ..config import avhubert_large

    return avhubert_large(use_lora=False)


def pretrain_loss(params: Params, cfg: AVHubertConfig, video: torch.Tensor,
                  audio_feats: torch.Tensor, targets: torch.Tensor,
                  lengths: Optional[torch.Tensor], key: torch.Tensor, dtype=torch.float32,
                  remat: str = "dots", **loss_kw) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The JAX CLI's `loss_fn` on {"enc", "head"} params in `dtype`: `kv, kp
    = split(key)`, the pre-training video pipeline under kv, the ResNet in
    eval mode, each modality's projection, then `avhubert_pretrain_loss`
    under kp (`loss_kw`: mask_prob, mask_length, modality_dropout,
    audio_dropout)."""
    kv, kp = prng.split(key)
    v = pretrain_video_pipeline(video, train=True, generator=kv).to(dtype)
    vf = resnet3d_forward(params["enc"]["video_frontend"], v)
    vfeat = linear(vf, params["enc"]["video_proj"])
    afeat = linear(audio_feats.to(dtype), params["enc"]["audio_proj"])
    return avhubert_pretrain_loss(params["enc"], params["head"], cfg, vfeat, afeat, targets,
                                  lengths, kp, remat=remat, **loss_kw)


def main(argv=None):
    p = argparse.ArgumentParser("pretrain_avhubert")
    p.add_argument("--exp-dir", default="./exp_pretrain")
    p.add_argument("--root-dir", default="")
    p.add_argument("--train-file", default="")
    p.add_argument("--labels-dir", default=None, help="cluster_units output")
    p.add_argument("--n-units", type=int, default=100)
    p.add_argument("--mask-prob", type=float, default=0.8)
    p.add_argument("--mask-length", type=int, default=10)
    p.add_argument("--modality-dropout", type=float, default=0.5)
    p.add_argument("--audio-dropout", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--max-steps", type=int, default=100)
    p.add_argument("--max-frames", type=int, default=500)
    p.add_argument("--final-dim", type=int, default=256)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--tiny", type=str2bool, default=False)
    p.add_argument("--device", default="cuda",
                   help="torch device; without a CUDA device the CLI stops unless given cpu")
    args = p.parse_args(argv)
    device = check_args(args)
    remat = read_numerics().remat
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32

    if args.synthetic:
        from ..data.synthetic import generate_corpus

        out_dir = os.path.join(args.exp_dir, "synthetic_data")
        os.makedirs(out_dir, exist_ok=True)
        train_csv, _, _ = generate_corpus(out_dir, n_train=args.synthetic)
        args.root_dir, args.train_file = out_dir, train_csv
        args.tiny = True
        args.n_units = 8
    cfg = pretrain_config(args.tiny)
    if args.tiny:
        args.final_dim = 16

    from ..bridge import init_avhubert, init_pretrain_head

    gen = torch.Generator(device=device).manual_seed(args.seed)
    masters = master_weights({"enc": init_avhubert(cfg, gen, device),
                              "head": init_pretrain_head(cfg, args.n_units, args.final_dim, gen,
                                                         device)}, device)
    leaves = list(tree_leaves(masters))
    tx, _ = make_optimizer(TrainConfig(lr=args.lr, max_epochs=1), args.max_steps)
    opt_state = tx.init(leaves)
    loss_kw = dict(mask_prob=args.mask_prob, mask_length=args.mask_length,
                   modality_dropout=args.modality_dropout, audio_dropout=args.audio_dropout)

    from ..data.audio_features import stacked_fbank
    from ..data.batching import CollateConfig, bucket_batches, collate
    from ..data.dataset import AVDataset
    from ..data.tokenizer import synthetic_tokenizer

    ds = AVDataset(args.root_dir, args.train_file, "audiovisual")
    tok = synthetic_tokenizer()
    unit_rate = labels_rate(args.labels_dir) if args.labels_dir else 100
    rng = prng.PRNGKey(args.seed)
    n_steps, t0 = 0, time.time()
    while n_steps < args.max_steps:
        for batch_idx in bucket_batches(ds.input_lengths, args.max_frames, 4, shuffle=True,
                                        seed=n_steps):
            samples = [ds[i] for i in batch_idx]
            b = collate(samples, tok, CollateConfig(modality="audiovisual"))
            T = b["video"].shape[1]
            names = [os.path.splitext(os.path.basename(ds.entries[i].rel_path))[0]
                     for i in batch_idx]
            if args.labels_dir:
                tgt = np.stack([load_unit_labels(args.labels_dir, nm, T, args.n_units, unit_rate)
                                for nm in names])
            else:
                tgt = demo_targets(b["audio"], T, args.n_units)
            afeats = np.stack([stacked_fbank(b["audio"][i], T) for i in range(len(samples))])
            params = tree_map(lambda x: x.to(dtype), masters)
            loss, aux = pretrain_loss(
                params, cfg, torch.from_numpy(b["video"]).to(device),
                torch.from_numpy(afeats).to(device), torch.from_numpy(tgt).to(device),
                torch.from_numpy(b["video_len"]).to(device), prng.fold_in(rng, n_steps), dtype,
                remat, **loss_kw)
            grads = torch.autograd.grad(loss, leaves)
            opt_state = tx.update_(leaves, list(grads), opt_state)
            loss = loss.detach()
            n_steps += 1
            if n_steps % 5 == 0 or n_steps == 1:
                print(f"step {n_steps}: loss={float(loss):.4f} "
                      f"acc_m={float(aux['acc_masked']):.3f}")
            if n_steps >= args.max_steps:
                break
    # the encoder and head, for cluster_units' layer-N dump (iterations 2-5)
    from ..train.checkpoint import save_checkpoint

    ckpt_path = save_checkpoint(os.path.join(args.exp_dir, "checkpoints"), n_steps,
                                TrainState(n_steps, masters, opt_state))
    with open(os.path.join(args.exp_dir, "config.json"), "w") as f:
        json.dump({"avhubert": dataclasses.asdict(cfg), "n_units": args.n_units,
                   "final_dim": args.final_dim}, f, indent=2)
    print(f"done {n_steps} steps in {time.time() - t0:.1f}s; saved {ckpt_path}")
    return masters


if __name__ == "__main__":
    main()
