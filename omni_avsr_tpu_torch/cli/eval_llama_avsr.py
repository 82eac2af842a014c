"""Evaluation CLI of the Llama-AVSR / Llama-MTSK baselines (port of
`omni_avsr_tpu/cli/eval_llama_avsr.py`; reference `eval_LlamaAVSR.py:
220-263`): the WER of one task, at every rate combo of the model or at the
rates of `--downsample-ratio-test-matry`, which takes [video, audio] for
AVSR (the reference's order, `modeling_LlamaAVSR.py:365-371`).

    python -m omni_avsr_tpu_torch.cli.eval_llama_avsr --synthetic 4 --modality audio \\
        --quantize-decode int8 --exp-dir /tmp/llama_eval      # on the card
    python -m omni_avsr_tpu_torch.cli.eval_llama_avsr ... --device cpu

`--quantize-decode int8|int4` quantises the LLM only, as the JAX CLI does
(`quantize_for_decode(..., llm_only=True)`; the towers stay bf16): B2 or
B6 in every LLM matrix, q|k|v and gate|up fused as in every decode tree of
the port.
"""

from __future__ import annotations

import argparse
import os

from ..config import TrainConfig
from ..data.datamodule import DataModule
from ..data.noise import load_noise_bank
from ..train.engine import OmniEngine
from ..utils.metrics import WerAccumulator
from .common import (
    add_baseline_prompt,
    add_common_args,
    build_data_config,
    build_model,
    build_params,
    check_args,
    maybe_synthetic,
    read_numerics,
    single_prompt,
    str2bool,
)
from .eval_omni import decode_tree


def parse_args(argv=None):
    p = argparse.ArgumentParser("eval_llama_avsr")
    add_common_args(p)
    add_baseline_prompt(p)
    p.add_argument("--downsample-ratio-test-matry", type=int, nargs="+", default=None,
                   help="[rate] or [video_rate, audio_rate] for AVSR")
    p.add_argument("--quantize-decode", default=None, choices=[None, "int8", "int4"],
                   help="weight-only quantised LLM: int8, or packed int4")
    p.add_argument("--test-batch-size", type=int, default=1,
                   help="decode N utterances at once (the masked prefix keeps batch-1 "
                        "semantics)")
    p.add_argument("--print-hyp", type=str2bool, default=True)
    args = p.parse_args(argv)
    single_prompt(args)
    return args


def rate_grid(args, engine: OmniEngine):
    if not args.downsample_ratio_test_matry:
        return engine._rate_combos(args.modality)
    r = args.downsample_ratio_test_matry
    if args.modality == "audiovisual":
        return [(r[1], r[0])]  # the reference's order: [video, audio]
    return [(r[0], None)] if args.modality == "audio" else [(None, r[0])]


def main(argv=None):
    args = parse_args(argv)
    device = check_args(args)
    maybe_synthetic(args)
    os.makedirs(args.exp_dir, exist_ok=True)

    model = build_model(args)
    params = build_params(args, model, device)
    data_cfg = build_data_config(args)
    noise = load_noise_bank(args.noise_path) if args.decode_snr_target < 999998 else None
    engine = OmniEngine(model, params, TrainConfig(), 1.0, noise_bank=noise,
                        decode_snr_target=args.decode_snr_target, seed=args.seed,
                        inference_only=True, device=device, **read_numerics().engine_kwargs())
    del params
    merged = decode_tree(engine, args.quantize_decode, llm_only=True)

    dm = DataModule(data_cfg, model.tok, modality=args.modality)
    for ra, rv in rate_grid(args, engine):
        acc = WerAccumulator()
        for batch in dm.test_batches(args.test_batch_size):
            hyps = engine.decode_batch(merged, batch, args.modality, ra, rv)
            for ref, hyp in zip(batch["gold_text"], hyps):
                acc.update(ref, hyp)
                if args.print_hyp:
                    print(f"GOLD: {ref}\nHYP : {hyp}")
        print(f"WER {args.modality} (a={ra}, v={rv}): {acc.wer:.4f} "
              f"({acc.total_edit_distance}/{acc.total_length})")


if __name__ == "__main__":
    main()
