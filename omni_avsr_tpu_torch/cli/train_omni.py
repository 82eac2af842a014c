"""Training CLI of the unified Omni-AVSR model (port of
`omni_avsr_tpu/cli/train_omni.py`; reference `train_OmniAVSR.py`, the same
flag names, see `cli/common.py`): the epoch loop with random matryoshka
rates per step (`OmniEngine.train_step`), validation and a checkpoint after
every epoch (keep-N), resume, the mean of the last N checkpoints after
training, and an automatic WER sweep over the task x rate grid
(`train_OmniAVSR.py:400-479`). Several ranks (one per device) train one
global step on a mesh (`--mesh-tp`, `--fsdp`, `--mesh-pp`, `--mesh-ep`,
`--sequence-parallel`; `cli/common.py::setup_parallelism`): launch them
with `python -m omni_avsr_tpu_torch.parallel.launch --nproc N -- python -m
omni_avsr_tpu_torch.cli.train_omni ...` or torchrun. Only rank 0 logs,
writes checkpoints (the whole tree) and runs the WER sweep.

    python -m omni_avsr_tpu_torch.cli.train_omni --synthetic 4 --max-epochs 2 \\
        --exp-dir /tmp/omni_smoke                            # on the card
    python -m omni_avsr_tpu_torch.cli.train_omni --synthetic 4 --device cpu ...

Checkpoints are the port's `step_<step>.pt` files (`train/checkpoint.py`)
under `<exp-dir>/<exp-name>/checkpoints/`; the average goes to
`<exp-dir>/<exp-name>/model_avg_<N>/`.
"""

from __future__ import annotations

import argparse
import os
import time

from ..config import TrainConfig
from ..data.datamodule import DataModule
from ..data.noise import load_noise_bank
from ..train.checkpoint import average_last_n, latest_checkpoint, restore_checkpoint, save_checkpoint
from ..train.engine import OmniEngine
from ..train.state import TrainState, master_weights
from ..utils.metrics import WerAccumulator
from ..utils.prefetch import device_prefetch
from ..utils.profiling import StepTimer, find_nonfinite, trace
from .common import (
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
    str2bool,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser("train_omni")
    add_common_args(p)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=0.1)
    p.add_argument("--warmup-epochs", type=float, default=0.0)
    p.add_argument("--max-epochs", type=int, default=8)
    p.add_argument("--gradient-clip-val", type=float, default=10.0)
    p.add_argument("--num-check-save", type=int, default=4)
    p.add_argument("--num-average-epochs", type=int, default=4)
    p.add_argument("--ckpt-path", default=None, help="resume from this checkpoint file")
    p.add_argument("--auto-resume", type=str2bool, default=True,
                   help="resume from the latest checkpoint in the experiment if present")
    p.add_argument("--auto-test", type=str2bool, default=True)
    p.add_argument("--wandb", type=str2bool, default=False)
    p.add_argument("--project-wandb", default="omni-avsr-tpu")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the first epoch's steps 2-4 here")
    p.add_argument("--detect-nan", type=str2bool, default=False,
                   help="debug: name the non-finite trainable leaves on a NaN loss")
    return p.parse_args(argv)


def main(argv=None):
    from ..parallel.distributed import is_primary

    args = parse_args(argv)
    device = initialize_from_args(args)
    maybe_synthetic(args)
    # the unified model trains all three tasks on every batch and needs AV
    # data (`modeling_OmniAVSR.py:263-306`)
    if args.modality != "audiovisual":
        raise ValueError(f"train_omni is the three-task trainer and needs --modality "
                         f"audiovisual, not {args.modality!r}")
    os.makedirs(args.exp_dir, exist_ok=True)
    ckpt_dir = os.path.join(args.exp_dir, args.exp_name, "checkpoints")

    model = build_model(args)
    params = build_params(args, model, device)
    mesh, feed, plan = setup_parallelism(args, device)
    dm = DataModule(build_data_config(args), model.tok, modality=args.modality)
    steps_per_epoch = max(dm.steps_per_epoch(), 1)
    train_cfg = TrainConfig(
        lr=args.lr, weight_decay=args.weight_decay, warmup_epochs=args.warmup_epochs,
        max_epochs=args.max_epochs, grad_clip=args.gradient_clip_val, seed=args.seed,
        num_checkpoints_to_average=args.num_average_epochs, checkpoint_dir=ckpt_dir)
    engine = OmniEngine(model, params, train_cfg, steps_per_epoch,
                        unfrozen_modules=tuple(args.unfrozen_modules),
                        noise_bank=load_noise_bank(args.noise_path), seed=args.seed,
                        device=device, **read_numerics().engine_kwargs(),
                        **engine_parallel_kwargs(args, mesh, plan))
    del params
    logger = primary_logger(args)

    start_epoch = 0
    resume_path = args.ckpt_path or (latest_checkpoint(ckpt_dir) if args.auto_resume else None)
    if resume_path:
        engine.load_state(restore_checkpoint(resume_path, device))
        start_epoch = engine.state.step // steps_per_epoch
        print(f"resumed from {resume_path} at epoch {start_epoch}")

    timer = StepTimer()
    for epoch in range(start_epoch, args.max_epochs):
        t0 = time.time()
        n, loss_sum, loss_n = 0, 0.0, 0
        # the next batches upload on a side stream while this step runs
        # (`omni_avsr_tpu/cli/train_omni.py:120-123`)
        batches = (map(feed, dm.train_batches(epoch)) if mesh is not None
                   else device_prefetch(dm.train_batches(epoch), device=device))
        for batch in batches:
            profiled = args.profile_dir if (epoch == start_epoch and 2 <= n <= 4) else None
            with trace(profiled, device):
                loss = engine.train_step(batch)
            timer.tick()
            n += 1
            if n % 10 == 0 or n == 1:
                loss_val = float(loss)  # a host sync
                loss_sum += loss_val
                loss_n += 1
                if args.detect_nan and loss_val != loss_val:
                    bad = find_nonfinite(engine.state.trainable)
                    raise FloatingPointError(f"NaN loss at step {engine.state.step}; "
                                             f"non-finite trainable leaves: {bad[:10]}")
                logger.log(engine.state.step, {"train_loss": loss_val,
                                               "lr": engine.schedule(engine.state.step),
                                               "step_time_s": timer.mean})
        train_loss = loss_sum / max(loss_n, 1)

        # validation (the reference logs loss_val, `lightning:185-190`)
        val_n, val_sum = 0, 0.0
        for batch in dm.val_batches():
            total, _ = engine.eval_step(feed(batch))
            val_sum += float(total)
            val_n += 1
        val_loss = val_sum / max(val_n, 1)
        state = engine.full_state()  # under a mesh a collective: every rank gathers
        if is_primary():
            print(f"epoch {epoch}: train_loss={train_loss:.4f} val_loss={val_loss:.4f} "
                  f"steps={n} ({time.time() - t0:.1f}s)")
            logger.log(engine.state.step, {"epoch": epoch, "loss_val": val_loss})
            save_checkpoint(ckpt_dir, engine.state.step, state, keep=args.num_check_save)
        del state

    # under a mesh every rank gathers the frozen tree (a collective); then the
    # primary alone averages, saves and tests, as the JAX CLI's other hosts stop
    base = engine.merged_params() if mesh is not None else None
    if not is_primary():
        return

    # the mean of the last N checkpoints (`utils/avg_checkpoints.py:34-44`),
    # saved outside ckpt_dir so that --auto-resume never resumes from
    # averaged weights with stale optimizer moments
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
        run_auto_test(args, model, engine, dm, logger, params)
    logger.close()


def run_auto_test(args, model, engine, dm, logger, params=None) -> dict:
    """The task x rate WER sweep (`train_OmniAVSR.py:426-478`); video is
    tested three times per rate (`:441-445`)."""
    params = engine.merged_params() if params is None else params
    results = {}
    tasks = [("audio", [(ra, None) for ra in model.cfg.audio_rates]),
             ("video", [(None, rv) for rv in model.cfg.video_rates]),
             ("audiovisual", [(ra, rv) for ra in model.cfg.audio_rates
                              for rv in model.cfg.video_rates])]
    for task, grid in tasks:
        if args.modality not in ("audiovisual", task):
            continue
        dm_task = DataModule(dm.cfg, dm.tok, modality=task)
        for ra, rv in grid:
            reps = 3 if task == "video" else 1
            for rep in range(reps):
                acc = WerAccumulator()
                for batch in dm_task.test_batches():
                    for ref, hyp in zip(batch["gold_text"],
                                        engine.decode_batch(params, batch, task, ra, rv)):
                        acc.update(ref, hyp)
                key = f"wer/{task}_a{ra}_v{rv}" + (f"_rep{rep}" if reps > 1 else "")
                results[key] = acc.wer
                print(f"{key}: {acc.wer:.4f}")
    logger.log(engine.state.step, results)
    return results


if __name__ == "__main__":
    main()
