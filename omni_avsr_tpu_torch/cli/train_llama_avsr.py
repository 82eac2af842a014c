"""Training CLI of the Llama-AVSR / Llama-MTSK baselines (port of
`omni_avsr_tpu/cli/train_llama_avsr.py`; reference `train_LlamaAVSR.py`):
one task per model (`--modality`), one prompt (`--prompt`) and a
modality-agnostic LoRA. With `--is-matryoshka` each step's loss is the
mean over every trained rate combo (Llama-MTSK,
`modeling_LlamaAVSR.py:244-251`; `OmniEngine.single_train_step`), where
the Omni model samples one. After training, the mean of the last N
checkpoints (`model_avg_<N>/`) and a WER test at every rate combo.

    python -m omni_avsr_tpu_torch.cli.train_llama_avsr --synthetic 6 --max-epochs 1 \\
        --modality audio --exp-dir /tmp/llama_avsr_smoke       # on the card
    python -m omni_avsr_tpu_torch.cli.train_llama_avsr ... --device cpu
"""

from __future__ import annotations

import argparse
import os
import time

from ..config import TrainConfig
from ..data.datamodule import DataModule
from ..data.noise import load_noise_bank
from ..train.checkpoint import average_last_n, restore_checkpoint, save_checkpoint
from ..train.engine import OmniEngine
from ..train.state import TrainState, master_weights
from ..utils.metrics import WerAccumulator
from .common import (
    add_baseline_prompt,
    add_common_args,
    build_data_config,
    build_model,
    build_params,
    engine_parallel_kwargs,
    initialize_from_args,
    maybe_synthetic,
    primary_logger,
    read_numerics,
    setup_parallelism,
    single_prompt,
    str2bool,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser("train_llama_avsr")
    add_common_args(p)
    add_baseline_prompt(p)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=0.1)
    p.add_argument("--warmup-epochs", type=float, default=0.0)
    p.add_argument("--max-epochs", type=int, default=8)
    p.add_argument("--gradient-clip-val", type=float, default=10.0)
    p.add_argument("--num-check-save", type=int, default=4)
    p.add_argument("--num-average-epochs", type=int, default=4)
    p.add_argument("--ckpt-path", default=None, help="resume from this checkpoint file")
    p.add_argument("--auto-test", type=str2bool, default=True)
    p.add_argument("--wandb", type=str2bool, default=False)
    p.add_argument("--project-wandb", default="omni-avsr-tpu")
    args = p.parse_args(argv)
    single_prompt(args)
    return args


def main(argv=None):
    from ..parallel.distributed import is_primary

    args = parse_args(argv)
    device = initialize_from_args(args)
    maybe_synthetic(args)
    os.makedirs(args.exp_dir, exist_ok=True)
    ckpt_dir = os.path.join(args.exp_dir, args.exp_name, "checkpoints")

    model = build_model(args)
    params = build_params(args, model, device)
    mesh, feed, plan = setup_parallelism(args, device)
    data_cfg = build_data_config(args)
    dm = DataModule(data_cfg, model.tok, modality=args.modality,
                    downsample_video=None if args.is_matryoshka else model.cfg.video_rates[0])
    steps_per_epoch = max(dm.steps_per_epoch(), 1)
    train_cfg = TrainConfig(
        lr=args.lr, weight_decay=args.weight_decay, warmup_epochs=args.warmup_epochs,
        max_epochs=args.max_epochs, grad_clip=args.gradient_clip_val, seed=args.seed,
        checkpoint_dir=ckpt_dir)
    # an audio-only model has no AV-HuBERT LoRA to train
    unfrozen = tuple(m for m in args.unfrozen_modules
                     if m != "lora_avhubert" or args.modality != "audio")
    noise = load_noise_bank(args.noise_path) if args.modality != "video" else None
    engine = OmniEngine(model, params, train_cfg, steps_per_epoch, unfrozen_modules=unfrozen,
                        noise_bank=noise, seed=args.seed, device=device,
                        **read_numerics().engine_kwargs(),
                        **engine_parallel_kwargs(args, mesh, plan))
    del params
    logger = primary_logger(args)

    start_epoch = 0
    if args.ckpt_path:
        engine.load_state(restore_checkpoint(args.ckpt_path, device))
        start_epoch = engine.state.step // steps_per_epoch

    for epoch in range(start_epoch, args.max_epochs):
        t0 = time.time()
        n, loss_sum, loss_n = 0, 0.0, 0
        for batch in dm.train_batches(epoch):
            loss = engine.single_train_step(feed(batch), args.modality)
            n += 1
            if n % 10 == 0 or n == 1:
                loss_val = float(loss)  # a host sync
                loss_sum += loss_val
                loss_n += 1
                logger.log(engine.state.step, {"loss": loss_val})
        val_sum, val_n = 0.0, 0
        for batch in dm.val_batches():
            val_sum += float(engine.single_eval_step(feed(batch), args.modality))
            val_n += 1
        state = engine.full_state()  # under a mesh a collective: every rank gathers
        if is_primary():
            print(f"epoch {epoch}: loss={loss_sum / max(loss_n, 1):.4f} "
                  f"loss_val={val_sum / max(val_n, 1):.4f} steps={n} "
                  f"({time.time() - t0:.1f}s)")
            logger.log(engine.state.step, {"epoch": epoch, "loss_val": val_sum / max(val_n, 1)})
            save_checkpoint(ckpt_dir, engine.state.step, state, keep=args.num_check_save)
        del state

    base = engine.merged_params() if mesh is not None else None  # a collective
    if not is_primary():
        return

    avg = average_last_n(ckpt_dir, min(args.num_average_epochs, args.max_epochs))
    avg_dir = os.path.join(args.exp_dir, args.exp_name, f"model_avg_{args.num_average_epochs}")
    save_checkpoint(avg_dir, engine.state.step,
                    TrainState(engine.state.step, avg, engine.state.opt_state), keep=0)
    print(f"averaged last {args.num_average_epochs} checkpoints -> {avg_dir}")
    if mesh is None:
        engine.state = TrainState(engine.state.step, master_weights(avg, engine.device),
                                  engine.state.opt_state)
        params = engine.merged_params()
    else:  # the averaged trainable tree over the gathered frozen one
        from ..train.state import merge_params, tree_map

        params = merge_params(tree_map(lambda x: x.to(device=device, dtype=model.dtype), avg),
                              base)

    if args.auto_test and args.test_file:
        dm_t = DataModule(data_cfg, model.tok, modality=args.modality)
        for ra, rv in engine._rate_combos(args.modality):
            acc = WerAccumulator()
            for batch in dm_t.test_batches():
                for ref, hyp in zip(batch["gold_text"],
                                    engine.decode_batch(params, batch, args.modality, ra, rv)):
                    acc.update(ref, hyp)
            print(f"wer/{args.modality}_a{ra}_v{rv}: {acc.wer:.4f}")
            logger.log(engine.state.step, {f"wer_a{ra}_v{rv}": acc.wer})
    logger.close()


if __name__ == "__main__":
    main()
