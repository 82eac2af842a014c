"""Evaluation CLI of the unified Omni-AVSR model (port of
`omni_avsr_tpu/cli/eval_omni.py`; reference `eval_OmniAVSR.py:18-24,
259-357`): WER over the task x matryoshka-rate grid, or one task or rate
(`--task-to-test`, `--test-specific-modality`, `--test-specific-ratio`),
decoded on the card through `OmniEngine.decode_batch`.

    python -m omni_avsr_tpu_torch.cli.eval_omni --synthetic 2 --num-beams 2 \\
        --max-dec-tokens 4 --quantize-decode int8            # on the card
    python -m omni_avsr_tpu_torch.cli.eval_omni --synthetic 2 --device cpu ...

`--quantize-decode int8|int4` decodes on the weight-only quantised tree
(`ops/quant.py::quantize_for_decode`, then `arrange_for_card`, as
`Transcriber` builds it): the int8 and packed-int4 matmul kernels.
"""

from __future__ import annotations

import argparse
import json
import os

from ..config import TrainConfig
from ..data.datamodule import DataModule
from ..data.noise import load_noise_bank
from ..train.engine import OmniEngine
from ..utils.metrics import BleuScorer, WerAccumulator
from .common import (
    add_common_args,
    build_data_config,
    build_model,
    build_params,
    check_args,
    maybe_synthetic,
    read_numerics,
    str2bool,
)

TASK_ALIASES = {"asr": "audio", "vsr": "video", "avsr": "audiovisual"}


def parse_args(argv=None):
    p = argparse.ArgumentParser("eval_omni")
    add_common_args(p)
    p.add_argument("--task-to-test", default=None, choices=[None, "asr", "vsr", "avsr"],
                   help="restrict the sweep to one task")
    p.add_argument("--test-specific-modality", default=None,
                   choices=[None, "audio", "video", "audiovisual"])
    p.add_argument("--test-specific-ratio", type=int, nargs="+", default=None,
                   help="[audio_rate] / [video_rate] / [audio_rate video_rate]")
    p.add_argument("--quantize-decode", default=None, choices=[None, "int8", "int4"],
                   help="weight-only quantised decode: int8, or packed int4 in the LLM")
    p.add_argument("--test-batch-size", type=int, default=1,
                   help="decode N utterances at once (the masked prefix keeps batch-1 "
                        "semantics)")
    p.add_argument("--print-hyp", type=str2bool, default=True,
                   help="print gold vs generated per sample (`lightning:203-204`)")
    p.add_argument("--output-json", default=None, help="write the WER results dict here")
    p.add_argument("--score-bleu", type=str2bool, default=False,
                   help="also report corpus BLEU-4 per setting (fairseq libbleu)")
    return p.parse_args(argv)


def rate_grid(args, model, task):
    if args.test_specific_ratio:
        r = args.test_specific_ratio
        if task == "audio":
            return [(r[0], None)]
        if task == "video":
            return [(None, r[-1])]
        return [(r[0], r[-1])]
    if task == "audio":
        return [(ra, None) for ra in model.cfg.audio_rates]
    if task == "video":
        return [(None, rv) for rv in model.cfg.video_rates]
    return [(ra, rv) for ra in model.cfg.audio_rates for rv in model.cfg.video_rates]


def tasks_of(args):
    if args.test_specific_modality:
        return [args.test_specific_modality]
    if args.task_to_test:
        return [TASK_ALIASES[args.task_to_test]]
    if args.modality != "audiovisual":
        return [args.modality]
    return ["audio", "video", "audiovisual"]


def decode_tree(engine: OmniEngine, quantize, **quantize_kw):
    """The serving tree: the merged parameters, quantised and arranged for
    the card layer by layer when asked (`ops/quant.py::quantize_for_card`,
    as `serve.py::Transcriber` builds it)."""
    merged = engine.merged_params()
    if quantize:
        from ..ops.quant import quantize_for_card

        merged = quantize_for_card(merged, quantize, lambda path, t: t.to(engine.device),
                                   **quantize_kw)
    return merged


def main(argv=None, environ=None):
    """`environ`: the `OMNI_*` variables to read (the process's environment
    when None; `verify_parity` passes its profile's)."""
    args = parse_args(argv)
    device = check_args(args)
    numerics = read_numerics(environ)
    maybe_synthetic(args)
    os.makedirs(args.exp_dir, exist_ok=True)

    model = build_model(args)
    params = build_params(args, model, device)
    data_cfg = build_data_config(args)
    noise = load_noise_bank(args.noise_path) if args.decode_snr_target < 999998 else None
    engine = OmniEngine(model, params, TrainConfig(), 1.0,
                        unfrozen_modules=tuple(args.unfrozen_modules), noise_bank=noise,
                        decode_snr_target=args.decode_snr_target, seed=args.seed,
                        inference_only=True, device=device, **numerics.engine_kwargs())
    del params
    merged = decode_tree(engine, args.quantize_decode)

    results = {}
    for task in tasks_of(args):
        dm = DataModule(data_cfg, model.tok, modality=task)
        for ra, rv in rate_grid(args, model, task):
            acc = WerAccumulator()
            bleu = BleuScorer() if args.score_bleu else None
            for batch in dm.test_batches(args.test_batch_size):
                hyps = engine.decode_batch(merged, batch, task, ra, rv)
                for ref, hyp in zip(batch["gold_text"], hyps):
                    acc.update(ref, hyp)
                    if bleu is not None:
                        bleu.update(ref, hyp)
                    if args.print_hyp:
                        print(f"GOLD: {ref}\nHYP : {hyp}")
            key = f"{task} (a={ra}, v={rv})"
            results[key] = acc.wer
            print(f"WER {key}: {acc.wer:.4f} ({acc.total_edit_distance}/{acc.total_length})")
            if bleu is not None:
                print(f"{key}: {bleu.result_string()}")

    print("\n=== summary ===")
    for k, v in results.items():
        print(f"{k}: {100 * v:.2f}%")
    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump({k: round(v, 6) for k, v in results.items()}, f, indent=2)
        print(f"wrote {args.output_json}")
    return results


if __name__ == "__main__":
    main()
