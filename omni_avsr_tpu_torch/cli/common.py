"""Shared CLI plumbing (port of `omni_avsr_tpu/cli/common.py`): the
reference's flag surface (`train_OmniAVSR.py:75-391`) mapped onto the
port's configs, and the model, parameter and data builders.

One flag is the port's own: `--device` (default "cuda"). Without a CUDA
device the CLIs stop with an error unless given `--device cpu`. The
parallel flags (`--num-nodes`, `--mesh-*`, `--fsdp`,
`--sequence-parallel`, `--moe-experts`) run as the JAX package's do
(`setup_parallelism`; one rank per device, started by
`parallel/launch.py`, torchrun or SLURM): sequence parallelism with an MoE
decoder and with a replicated attention or MLP included.
`--compilation-cache-dir` is accepted and prints one line: the port
compiles no XLA program.

The JAX package's numerics variables (`OMNI_PROFILE`, `OMNI_PRNG`,
`OMNI_BN_STATS`, `OMNI_BEAM_SELECT`, `OMNI_BEAM_ATTN`, `OMNI_SELECT_KERNEL`,
`OMNI_CONV_KERNEL`, `OMNI_REMAT`, `OMNI_SP`) are read here, once per CLI
run (`read_numerics`, `utils/profiles.py`), and passed down as arguments.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any, Dict, Tuple

import torch

from ..config import (
    LLM_REGISTRY,
    AVHubertConfig,
    DataConfig,
    LLMConfig,
    LoRAConfig,
    OmniConfig,
    WhisperEncoderConfig,
    avhubert_large,
    default_v_divisor,
    whisper_base_en,
    whisper_medium_en,
    whisper_small_en,
)
from ..data.tokenizer import load_hf_tokenizer, synthetic_tokenizer
from ..models.common import Params
from ..models.omni import OmniAVSR
from ..utils.profiles import Numerics, resolve


def str2bool(v: str) -> bool:
    # the reference's `type=bool` makes any non-empty string True
    # (`train_OmniAVSR.py:159-163`); the flag names stay, the parsing is sane
    return str(v).lower() not in ("false", "0", "no", "")


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--exp-dir", default="./exp")
    p.add_argument("--exp-name", default="omni")
    p.add_argument("--modality", default="audiovisual",
                   choices=["audio", "video", "audiovisual"])
    p.add_argument("--llm-model", default="meta-llama/Llama-3.2-1B")
    p.add_argument("--audio-encoder-name", default="openai/whisper-medium.en")
    p.add_argument("--pretrain-avhubert-enc-video-path", default=None)
    p.add_argument("--use-lora-avhubert", type=str2bool, default=True)
    p.add_argument("--add-PETF-LLM", default="lora")
    p.add_argument("--rank", type=int, default=32)
    p.add_argument("--alpha", type=int, default=4)
    p.add_argument("--is-task-specific", type=str2bool, default=True)
    p.add_argument("--use-shared-lora-task-specific", type=str2bool, default=False)
    p.add_argument("--is-matryoshka", type=str2bool, default=True)
    p.add_argument("--is-single-matry-projector", type=str2bool, default=False)
    p.add_argument("--compression-mode", default="avg-pooling", choices=["avg-pooling", "stack"])
    p.add_argument("--whisper-input-mode", default="pad30s", choices=["pad30s", "bucket"],
                   help="pad30s = the reference's 30 s Whisper window; bucket = only the "
                        "batch's audio window")
    p.add_argument("--fused-task-forward", type=str2bool, default=False,
                   help="run the three training tasks as one stacked decoder forward (the "
                        "same losses)")
    p.add_argument("--downsample-ratio-audio", type=int, nargs="+", default=[4, 16])
    p.add_argument("--downsample-ratio-video", type=int, nargs="+", default=[2, 5])
    p.add_argument("--matry-weights", type=float, nargs=3, default=[1.0, 1.5, 1.0])
    p.add_argument("--no-layernorm-projector", type=str2bool, default=False)
    p.add_argument("--intermediate-size", type=int, default=2048)
    p.add_argument("--prompt-audio", default="Transcribe speech to text.")
    p.add_argument("--prompt-video", default="Transcribe video to text.")
    p.add_argument("--prompt-audiovisual", default="Transcribe speech and video to text.")
    p.add_argument("--unfrozen-modules", nargs="+", default=["peft_llm", "lora_avhubert"])
    p.add_argument("--max-dec-tokens", type=int, default=32)
    p.add_argument("--num-beams", type=int, default=15)
    # data
    p.add_argument("--root-dir", default="")
    p.add_argument("--train-file", default="")
    p.add_argument("--val-file", default="")
    p.add_argument("--test-file", default="")
    p.add_argument("--max-frames-audio", type=int, default=1500)
    p.add_argument("--max-frames-video", type=int, default=1000)
    p.add_argument("--max-frames-audiovisual", type=int, default=1000)
    p.add_argument("--train-num-buckets", type=int, default=400)
    p.add_argument("--num-workers", type=int, default=5)
    p.add_argument("--decode-snr-target", type=float, default=999999)
    p.add_argument("--noise-path", default=None)
    # checkpoints
    p.add_argument("--pretrained-model-path", default=None,
                   help="trained reference .pth, or a directory of the port's checkpoints")
    p.add_argument("--whisper-path", default=None, help="HF Whisper .bin/.pth state dict")
    p.add_argument("--llm-path", default=None, help="HF Llama/Qwen state dict")
    p.add_argument("--seed", type=int, default=42)
    # ranks and meshes (`parallel/`, one rank per device; launch the ranks with
    # `python -m omni_avsr_tpu_torch.parallel.launch --nproc N -- ...` or torchrun)
    p.add_argument("--num-nodes", type=int, default=1,
                   help="ranks (one per device); > 1 with --coordinator-address starts them")
    p.add_argument("--coordinator-address", default=None,
                   help="host:port of rank 0 (else torchrun's or SLURM's environment)")
    p.add_argument("--node-rank", type=int, default=None,
                   help="this process's rank (RANK or SLURM_PROCID if unset)")
    p.add_argument("--mesh-tp", type=int, default=1,
                   help="tensor-parallel mesh axis size (ranks split dp x tp)")
    p.add_argument("--fsdp", type=str2bool, default=False,
                   help="additionally shard the LLM matrices over the dp axis (ZeRO-3)")
    p.add_argument("--mesh-pp", type=int, default=1,
                   help="pipeline stages: the decoder layer stack shards over a pp axis and "
                        "the train step runs the GPipe schedule (parallel/pipeline.py)")
    p.add_argument("--pp-microbatches", type=int, default=4,
                   help="GPipe microbatches per step (batch must divide)")
    p.add_argument("--mesh-ep", type=int, default=1,
                   help="expert-parallel axis: shards --moe-experts expert weights over ep")
    p.add_argument("--sequence-parallel", type=str2bool, default=False,
                   help="shard the decoder residual stream's time axis over tp between "
                        "layers (the JAX package's OMNI_SP=1; needs --mesh-tp > 1)")
    p.add_argument("--moe-experts", type=int, default=0)
    p.add_argument("--moe-routing", default="balanced", choices=["balanced", "top1"])
    p.add_argument("--moe-capacity-factor", type=float, default=1.25)
    p.add_argument("--compilation-cache-dir", default=None,
                   help="the JAX package's XLA cache: accepted; the port compiles no XLA "
                        "program (its kernels are cached under build/torch_kernels/)")
    # offline smoke mode
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate N synthetic train clips and run offline with a tiny model")
    p.add_argument("--tiny", type=str2bool, default=False, help="tiny encoder/LLM dims")
    p.add_argument("--device", default="cuda",
                   help="torch device; without a CUDA device the CLI stops unless given cpu")




def add_baseline_prompt(p: argparse.ArgumentParser) -> None:
    """The Llama-AVSR baselines' one prompt (`--prompt`)."""
    p.add_argument("--prompt", default="Transcribe speech to text.",
                   help="the baseline's single prompt")


def single_prompt(args) -> None:
    """The baselines' model: one prompt for every task and a
    modality-agnostic LoRA (`omni_avsr_tpu/cli/train_llama_avsr.py:62-65`)."""
    args.prompt_audio = args.prompt_video = args.prompt_audiovisual = args.prompt
    args.is_task_specific = False
    args.use_shared_lora_task_specific = False


def check_args(args) -> torch.device:
    """Refuse a missing card; returns the device to run on."""
    if getattr(args, "compilation_cache_dir", None):
        print(f"--compilation-cache-dir {args.compilation_cache_dir}: the port compiles no XLA "
              f"program; its CUDA kernels are cached under build/torch_kernels/")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here. The port runs on "
                         f"the card; pass --device cpu to run on the CPU.")
    return device


def initialize_from_args(args) -> torch.device:
    """Start this rank's process group when several ranks are asked for
    (`parallel/distributed.py::maybe_initialize_distributed`: the flags,
    then torchrun's or SLURM's environment; NCCL on the card, gloo with
    `--device cpu`), before anything else touches a device. Returns the
    rank's device (`cuda:LOCAL_RANK` on the card)."""
    from ..parallel.distributed import local_device, maybe_initialize_distributed

    device = check_args(args)
    maybe_initialize_distributed(num_nodes=args.num_nodes,
                                 coordinator_address=args.coordinator_address,
                                 node_rank=args.node_rank, device=device)
    return local_device(device)


def setup_parallelism(args, device=None):
    """(mesh, feed, plan) of the flags (`omni_avsr_tpu/cli/common.py:
    281-355`): the (dp[, pp][, ep], tp) mesh over the world, with dp the
    ranks left over by tp x pp x ep, when several ranks run or any model
    axis or `--fsdp` is asked for; else (None, identity, None). `feed`
    keeps this rank's `host_shard_slice` rows of the deterministic global
    batch (every rank iterates the same batches; its dp coordinate picks
    its rows) as tensors on `device`; `plan` is the `PipelinePlan` of
    `--mesh-pp` / `--pp-microbatches`. The engine shards the parameters
    (`OmniEngine(mesh=...)`)."""
    import numpy as np

    from ..parallel.distributed import global_batch_from_local, host_shard_slice, process_count

    pp, ep, tp = args.mesh_pp, args.mesh_ep, args.mesh_tp
    if read_numerics().sp:  # the JAX package's OMNI_SP=1 is --sequence-parallel
        args.sequence_parallel = True
    if args.sequence_parallel:
        assert tp > 1, "--sequence-parallel needs --mesh-tp > 1"
    use_mesh = process_count() > 1 or tp > 1 or pp > 1 or ep > 1 or args.fsdp
    if not use_mesh:
        return None, (lambda b: b), None
    import torch.distributed as dist

    from ..config import MeshConfig
    from ..parallel.mesh import AXIS_DP, axis, make_mesh

    n = process_count()
    model_axes = tp * pp * ep
    assert n % model_axes == 0, f"{n} devices not divisible by tp*pp*ep={model_axes}"
    if not dist.is_initialized():
        raise ValueError("a mesh needs a process group: launch the ranks with "
                         "`python -m omni_avsr_tpu_torch.parallel.launch --nproc N -- ...`")
    mesh = make_mesh(MeshConfig(dp=n // model_axes, tp=tp, pp=pp, ep=ep))
    plan = None
    if pp > 1:
        from ..parallel.pipeline import AXIS_PP, PipelinePlan

        plan = PipelinePlan(mesh, num_microbatches=args.pp_microbatches, axis=AXIS_PP,
                            dp_axis=AXIS_DP)
    dp = axis(mesh, AXIS_DP)

    def feed(batch):
        arrays = {k: v for k, v in batch.items()
                  if not isinstance(v, (int, float, str, list)) and v is not None}
        rest = {k: v for k, v in batch.items() if k not in arrays}
        B = next(iter(arrays.values())).shape[0]
        assert B % dp.size == 0, (
            f"global batch {B} not divisible by {dp.size} processes — raise the "
            f"batch bucket size or lower --num-nodes")
        sl = host_shard_slice(B, dp.rank, dp.size)
        out = global_batch_from_local(mesh, {k: np.asarray(v)[sl] for k, v in arrays.items()},
                                      device)
        out.update(rest)
        return out

    return mesh, feed, plan


def engine_parallel_kwargs(args, mesh, plan) -> Dict[str, Any]:
    """The `OmniEngine` arguments of the mesh flags, after
    `setup_parallelism` has resolved `--sequence-parallel`."""
    if mesh is None:
        return {}
    return dict(mesh=mesh, fsdp=args.fsdp, pipeline=plan,
                sequence_parallel=args.sequence_parallel)


def primary_logger(args):
    """The run's `MetricLogger` on the primary rank; elsewhere one that
    writes nothing (logs and checkpoints are the primary's)."""
    from ..parallel.distributed import is_primary
    from ..utils.logging import MetricLogger

    if is_primary():
        return MetricLogger(args.exp_dir, args.exp_name, use_wandb=args.wandb,
                            project=args.project_wandb, config=vars(args))

    class _Quiet:
        def log(self, *a, **k):
            pass

        def close(self):
            pass

    return _Quiet()


def tiny_dims() -> Tuple[WhisperEncoderConfig, AVHubertConfig, Dict[str, int]]:
    whisper = WhisperEncoderConfig(hidden_size=64, num_layers=2, num_heads=4, ffn_dim=128)
    avhubert = AVHubertConfig(encoder_embed_dim=64, encoder_layers=2, encoder_heads=4,
                              encoder_ffn_dim=128, audio_feat_dim=26, lora_rank_divisor=16)
    # head size 16, which B1 lacks: its decode takes the reorder route
    llm_dims = dict(hidden_size=128, intermediate_size=256, num_layers=2,
                    num_heads=8, num_kv_heads=4, head_dim=16)
    return whisper, avhubert, llm_dims


def read_numerics(environ=None) -> Numerics:
    """The JAX package's `OMNI_*` switches of `environ` (the process's
    environment when None), with `OMNI_PROFILE`'s baseline under them."""
    return resolve(os.environ if environ is None else environ)


def apply_numerics(transcriber, numerics: Numerics):
    """Set a `Transcriber`'s decode switches from `numerics`; the selection
    kernel only where the vocabulary allows it, as the JAX package gates
    its `OMNI_SELECT_KERNEL=1`."""
    from ..decode.decoding import select_kernel_supported

    transcriber.attn_route = numerics.beam_attn
    transcriber.select_mode = numerics.beam_select
    transcriber.conv_kernel = numerics.conv_kernel
    transcriber.select_kernel = (numerics.select_kernel and select_kernel_supported(
        transcriber.model.cfg.llm.vocab_size))
    return transcriber


def build_model(args) -> OmniAVSR:
    """The OmniAVSR of the flags: the registry's LLM at the tokenizer's
    vocabulary with the named Whisper and AV-HuBERT-Large, or the tiny
    dims with a synthetic tokenizer under `--tiny` / `--synthetic`."""
    use_tiny = args.tiny or args.synthetic
    lora = None
    if args.add_PETF_LLM == "lora":
        lora = LoRAConfig(rank_divisor=args.rank, alpha=args.alpha,
                          task_specific=args.is_task_specific,
                          shared=args.use_shared_lora_task_specific,
                          v_out_divisor=default_v_divisor(args.llm_model))
    if use_tiny:
        tok = synthetic_tokenizer("qwen" if "Qwen" in args.llm_model else "llama")
        whisper, avhubert, llm_dims = tiny_dims()
        llm = LLMConfig(
            family=tok.family, vocab_size=tok.vocab_size,
            rope_scaling_factor=32.0 if tok.family == "llama" else None,
            attention_bias=(tok.family == "qwen"),
            lora=dataclasses.replace(lora, rank_divisor=8, v_out_divisor=2) if lora else None,
            **llm_dims)
    else:
        tok = load_hf_tokenizer(args.llm_model)
        llm = LLM_REGISTRY[args.llm_model](lora=lora, vocab_size=tok.vocab_size)
        name = args.audio_encoder_name
        whisper = (whisper_medium_en() if "medium" in name
                   else whisper_small_en() if "small" in name else whisper_base_en())
        avhubert = avhubert_large(use_lora=args.use_lora_avhubert)

    if getattr(args, "moe_experts", 0):  # `omni_avsr_tpu/cli/common.py:185-188`
        llm = dataclasses.replace(llm, moe_experts=args.moe_experts, moe_routing=args.moe_routing,
                                  moe_capacity_factor=args.moe_capacity_factor)

    rates_a = tuple(args.downsample_ratio_audio)
    rates_v = tuple(args.downsample_ratio_video)
    if not args.is_matryoshka:
        rates_a, rates_v = rates_a[:1], rates_v[:1]
    cfg = OmniConfig(
        llm_model=args.llm_model, llm=llm, whisper=whisper, avhubert=avhubert,
        modality=args.modality, compression_mode=args.compression_mode,
        whisper_input_mode=args.whisper_input_mode,
        fused_task_forward=args.fused_task_forward,
        downsample_ratio_audio=rates_a, downsample_ratio_video=rates_v,
        is_matryoshka=args.is_matryoshka,
        is_single_matry_projector=args.is_single_matry_projector,
        remove_layernorm_from_projector=args.no_layernorm_projector,
        projector_intermediate_size=(32 if use_tiny else args.intermediate_size),
        matry_weights=tuple(args.matry_weights),
        is_task_specific=args.is_task_specific,
        use_shared_lora_task_specific=args.use_shared_lora_task_specific,
        prompt_audio=args.prompt_audio, prompt_video=args.prompt_video,
        prompt_audiovisual=args.prompt_audiovisual,
        max_dec_tokens=args.max_dec_tokens, num_beams=args.num_beams,
    )
    return OmniAVSR(cfg, tok)


def _strip_encoder_prefix(sd: Dict[str, Any]) -> Dict[str, Any]:
    return {k.replace("model.encoder.", "").replace("encoder.", "", 1)
            if k.startswith(("model.encoder.", "encoder.")) else k: v for k, v in sd.items()}


def build_params(args, model: OmniAVSR, device) -> Params:
    """The parameter tree, by precedence: a trained reference `.pth`
    (`--pretrained-model-path` as a file); else random weights from
    `--seed` (`bridge.init_params`, on `device`) with the towers and LLM of
    `--whisper-path`, `--pretrain-avhubert-enc-video-path` and
    `--llm-path` converted over them, and a directory of the port's
    checkpoints (`--pretrained-model-path` as a directory), which holds the
    trainable tree only, merged over the result."""
    from ..convert.omni_ckpt import load_torch_checkpoint

    path = args.pretrained_model_path
    if path and not os.path.isdir(path):
        from ..convert.omni_ckpt import convert_omni_checkpoint

        return convert_omni_checkpoint(load_torch_checkpoint(path), model.cfg)

    from ..bridge import init_params

    params = init_params(model.cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    if args.whisper_path:
        from ..convert.whisper_torch import convert_whisper_encoder

        sd = _strip_encoder_prefix(load_torch_checkpoint(args.whisper_path))
        params["whisper"] = convert_whisper_encoder(sd, model.cfg.whisper)
    if args.pretrain_avhubert_enc_video_path:
        from ..convert.avhubert_torch import convert_avhubert

        sd = load_torch_checkpoint(args.pretrain_avhubert_enc_video_path)
        params["avhubert"] = convert_avhubert(sd, model.cfg.avhubert)
    if args.llm_path:
        from ..convert.llm_torch import convert_llm

        params["llm"] = convert_llm(load_torch_checkpoint(args.llm_path), model.cfg.llm)
    if path:
        from ..train.checkpoint import resolve_checkpoint, restore_trainable
        from ..train.state import merge_params

        params = merge_params(restore_trainable(resolve_checkpoint(path), device), params)
    return params


def build_data_config(args) -> DataConfig:
    return DataConfig(
        root_dir=args.root_dir, train_file=args.train_file,
        val_file=args.val_file, test_file=args.test_file,
        max_frames_audio=args.max_frames_audio,
        max_frames_video=args.max_frames_video,
        max_frames_audiovisual=args.max_frames_audiovisual,
        train_num_buckets=args.train_num_buckets,
        num_workers=args.num_workers,
        decode_snr_target=args.decode_snr_target,
    )


def maybe_synthetic(args) -> None:
    """--synthetic N: write an offline corpus under the experiment directory
    and point the data flags at it."""
    if not args.synthetic:
        return
    import torch.distributed as dist

    from ..data.synthetic import generate_corpus
    from ..parallel.distributed import is_primary

    out_dir = os.path.join(args.exp_dir, "synthetic_data")
    files = [None]
    if is_primary():  # one writer; the other ranks read its manifests
        os.makedirs(out_dir, exist_ok=True)
        files = [generate_corpus(out_dir, n_train=args.synthetic)]
    if dist.is_initialized():
        dist.broadcast_object_list(files, src=0)
    args.train_file, args.val_file, args.test_file = files[0]
    args.root_dir = out_dir
    args.max_frames_audiovisual = 200
    args.train_num_buckets = 4
    args.num_workers = 2
    args.num_beams = min(args.num_beams, 3)
