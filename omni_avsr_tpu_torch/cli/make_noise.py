"""Noise-bank construction CLI (MUSAN / LRS3 babble preparation; port of
`omni_avsr_tpu/cli/make_noise.py`, the same files bit for bit). It runs on
the host only: numpy and the standard library's `wave`.

Replaces the reference's SLURM-bound `musan_prepare.py` / `lrs3_noise.py` /
`mix_babble.py` with one local tool. The resulting wav plugs into training
and eval via `--noise-path` (the reference's bundled
`datamodule/babble_noise.wav`, used by `datamodule/transforms.py:10-12,60-81`).

  # LRS3-style: one babble noise.wav from 30 long training clips
  python -m omni_avsr_tpu_torch.cli.make_noise babble \\
      --input-dir data/lrs3 --output noise/babble/noise.wav

  # MUSAN-style: speaker-held-out many-mixture bank
  python -m omni_avsr_tpu_torch.cli.make_noise musan-babble \\
      --input-dir musan/speech --output-dir musan/babble/wav \\
      --num-train 8000 --num-valid 1000 --num-test 1000

  # 10-second clip splitting (short-musan)
  python -m omni_avsr_tpu_torch.cli.make_noise split \\
      --input-dir musan/noise --output-dir musan/short-noise --seconds 10
"""

from __future__ import annotations

import argparse
import os
from typing import List


def find_wavs(input_dir: str) -> List[str]:
    out = []
    for root, _, files in os.walk(input_dir):
        for f in sorted(files):
            if f.endswith(".wav"):
                out.append(os.path.join(root, f))
    return out


def main(argv=None):
    p = argparse.ArgumentParser("make_noise")
    sub = p.add_subparsers(dest="mode", required=True)

    b = sub.add_parser("babble", help="single LRS3-style babble noise.wav")
    b.add_argument("--input-dir", required=True, help="dir of 16 kHz source wavs")
    b.add_argument("--output", required=True, help="output noise.wav path")
    b.add_argument("--num-per-mixture", type=int, default=30)
    b.add_argument("--min-seconds", type=float, default=15.0)
    b.add_argument("--seed", type=int, default=0)

    m = sub.add_parser("musan-babble", help="speaker-split MUSAN babble bank")
    m.add_argument("--input-dir", required=True, help="musan/speech dir")
    m.add_argument("--output-dir", required=True)
    m.add_argument("--num-per-mixture", type=int, default=30)
    m.add_argument("--num-train", type=int, default=8000)
    m.add_argument("--num-valid", type=int, default=1000)
    m.add_argument("--num-test", type=int, default=1000)
    m.add_argument("--seed", type=int, default=0)

    s = sub.add_parser("split", help="split wavs into fixed-length clips")
    s.add_argument("--input-dir", required=True)
    s.add_argument("--output-dir", required=True)
    s.add_argument("--seconds", type=float, default=10.0)

    args = p.parse_args(argv)
    from ..preprocess.noise_prep import (
        make_babble_wav,
        make_musan_babble,
        split_clips,
    )

    wavs = find_wavs(args.input_dir)
    print(f"found {len(wavs)} wavs under {args.input_dir}")
    if args.mode == "babble":
        out, n = make_babble_wav(wavs, args.output,
                                 num_per_mixture=args.num_per_mixture,
                                 min_seconds=args.min_seconds, seed=args.seed)
        print(f"wrote {out} (mixed {n} clips); use with --noise-path {out}")
    elif args.mode == "musan-babble":
        counts = {"train": args.num_train, "valid": args.num_valid,
                  "test": args.num_test}
        outs = make_musan_babble(wavs, args.output_dir,
                                 num_per_mixture=args.num_per_mixture,
                                 counts=counts, seed=args.seed)
        for split, files in outs.items():
            print(f"{split}: {len(files)} mixtures")
    else:
        outs = split_clips(wavs, args.output_dir, seconds=args.seconds)
        print(f"wrote {len(outs)} clips to {args.output_dir}")


if __name__ == "__main__":
    main()
