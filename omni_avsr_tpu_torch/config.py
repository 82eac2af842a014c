"""Typed configuration for the PyTorch port.

A copy of the dataclasses of `omni_avsr_tpu/config.py` and its model
registry (the port imports nothing of the JAX package): Llama-3.2-1B/3B,
Llama-3.1-8B and Qwen2.5 0.5B-32B under `LLM_REGISTRY`, the per-model LoRA
V divisor, and the Whisper and AV-HuBERT sizes. Field names, defaults and
the published geometries are the same, so a config built here describes
the same model as its JAX twin.

  - LLM hidden sizes: `Omni_AVSR/lightning_OmniAVSR.py:28-37`
  - LoRA geometry: `Omni_AVSR/Llama_LoRA.py:103-230` (RANK is a reduction
    divisor: bottleneck = round(hidden / RANK), scaling = ALPHA / RANK)
  - AV-HuBERT Large: 24 layers / 1024 dim (`av_hubert/avhubert/hubert.py`)
  - Whisper medium.en encoder: 24 layers / 1024 dim / 16 heads
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

MODALITIES: Tuple[str, ...] = ("audio", "video", "audiovisual")
Modality = str  # "audio" | "video" | "audiovisual"


@dataclass(frozen=True)
class LoRAConfig:
    """Omni-LoRA adapter geometry for the LLM decoder
    (`Omni_AVSR/Llama_LoRA.py:103-110`)."""

    rank_divisor: int = 32
    alpha: int = 4
    task_specific: bool = False
    shared: bool = False
    v_out_divisor: int = 4

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank_divisor

    def bottleneck(self, hidden_size: int) -> int:
        return int(round(hidden_size / self.rank_divisor))


@dataclass(frozen=True)
class LLMConfig:
    """Decoder-only LLM config of the Llama-3.x and Qwen-2.5 families: Qwen
    has q/k/v bias, plain rope (no llama3 rescale) and rms eps 1e-6."""

    family: str = "llama"
    vocab_size: int = 128256
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_layers: int = 16
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 64
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    rope_scaling_factor: Optional[float] = 32.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    tie_word_embeddings: bool = True
    attention_bias: bool = False
    max_position_embeddings: int = 131072
    lora: Optional[LoRAConfig] = None
    # Mixture-of-Experts FFN (`models/moe.py`): moe_experts > 0 replaces each
    # layer's SwiGLU MLP with an E-expert MoE of the same FFN width.
    # "balanced" routing gives every expert an equal load (fairseq's BASE
    # layers), "top1" is capacity routing, tokens past capacity falling
    # through on the residual (`omni_avsr_tpu/config.py:93-101`).
    moe_experts: int = 0
    moe_routing: str = "balanced"  # "balanced" | "top1"
    moe_capacity_factor: float = 1.25

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


def llama32_1b(lora: Optional[LoRAConfig] = None, vocab_size: int = 128256) -> LLMConfig:
    """meta-llama/Llama-3.2-1B"""
    return LLMConfig(
        family="llama", vocab_size=vocab_size, hidden_size=2048,
        intermediate_size=8192, num_layers=16, num_heads=32, num_kv_heads=8,
        head_dim=64, rms_norm_eps=1e-5, rope_theta=500000.0,
        tie_word_embeddings=True, lora=lora,
    )


def llama32_3b(lora: Optional[LoRAConfig] = None, vocab_size: int = 128256) -> LLMConfig:
    """meta-llama/Llama-3.2-3B"""
    return LLMConfig(
        family="llama", vocab_size=vocab_size, hidden_size=3072,
        intermediate_size=8192, num_layers=28, num_heads=24, num_kv_heads=8,
        head_dim=128, rms_norm_eps=1e-5, rope_theta=500000.0,
        tie_word_embeddings=True, lora=lora,
    )


def llama31_8b(lora: Optional[LoRAConfig] = None, vocab_size: int = 128256) -> LLMConfig:
    """meta-llama/Meta-Llama-3.1-8B"""
    return LLMConfig(
        family="llama", vocab_size=vocab_size, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        head_dim=128, rms_norm_eps=1e-5, rope_theta=500000.0,
        rope_scaling_factor=8.0, tie_word_embeddings=False, lora=lora,
    )


_QWEN25 = {
    # name: (hidden, inter, layers, heads, kv_heads, tie)
    "0.5B": (896, 4864, 24, 14, 2, True),
    "1.5B": (1536, 8960, 28, 12, 2, True),
    "3B": (2048, 11008, 36, 16, 2, True),
    "7B": (3584, 18944, 28, 28, 4, False),
    "14B": (5120, 13824, 48, 40, 8, False),
    "32B": (5120, 27648, 64, 40, 8, False),
}

# GQA-aware V-up output divisors per Qwen size (`Qwen_LoRA.py:464-473`).
QWEN_V_DIVISOR = {"0.5B": 7, "1.5B": 6, "3B": 8, "7B": 7, "14B": 5, "32B": 5}


def qwen25(size: str, lora: Optional[LoRAConfig] = None, vocab_size: int = 151936) -> LLMConfig:
    """Qwen/Qwen2.5-{size}: q/k/v bias, plain rope (theta 1e6), rms eps 1e-6."""
    h, i, l, nh, nkv, tie = _QWEN25[size]
    return LLMConfig(
        family="qwen", vocab_size=vocab_size, hidden_size=h,
        intermediate_size=i, num_layers=l, num_heads=nh, num_kv_heads=nkv,
        head_dim=h // nh, rms_norm_eps=1e-6, rope_theta=1000000.0,
        rope_scaling_factor=None, tie_word_embeddings=tie,
        attention_bias=True, lora=lora,
    )


# HF model name -> constructor (`lightning_OmniAVSR.py:28-37`).
LLM_REGISTRY = {
    "meta-llama/Llama-3.2-1B": lambda lora=None, vocab_size=128256: llama32_1b(lora, vocab_size),
    "meta-llama/Llama-3.2-3B": lambda lora=None, vocab_size=128256: llama32_3b(lora, vocab_size),
    "meta-llama/Meta-Llama-3.1-8B": lambda lora=None, vocab_size=128256: llama31_8b(lora, vocab_size),
    **{
        f"Qwen/Qwen2.5-{s}": (lambda s: (lambda lora=None, vocab_size=151936: qwen25(s, lora, vocab_size)))(s)
        for s in _QWEN25
    },
}


def default_v_divisor(llm_model: str) -> int:
    """GQA V-up divisor the reference hard-codes per model (`Llama_LoRA.py:143-187`)."""
    if "Qwen" in llm_model:
        return QWEN_V_DIVISOR[llm_model.split("-")[-1]]
    if llm_model == "meta-llama/Llama-3.2-3B":
        return 3
    return 4  # Llama-3 8B / 3.1-8B / 3.2-1B


@dataclass(frozen=True)
class WhisperEncoderConfig:
    """HF WhisperModel.encoder geometry (`modeling_OmniAVSR.py:59-62`)."""

    num_mel_bins: int = 80
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_dim: int = 4096
    max_source_positions: int = 1500
    layer_norm_eps: float = 1e-5


def whisper_medium_en() -> WhisperEncoderConfig:
    return WhisperEncoderConfig()


def whisper_small_en() -> WhisperEncoderConfig:
    return WhisperEncoderConfig(hidden_size=768, num_layers=12, num_heads=12, ffn_dim=3072)


def whisper_base_en() -> WhisperEncoderConfig:
    return WhisperEncoderConfig(hidden_size=512, num_layers=6, num_heads=8, ffn_dim=2048)


@dataclass(frozen=True)
class AVHubertConfig:
    """AV-HuBERT video encoder (`av_hubert/avhubert/hubert.py:318-360`)."""

    encoder_embed_dim: int = 1024
    encoder_layers: int = 24
    encoder_heads: int = 16
    encoder_ffn_dim: int = 4096
    audio_feat_dim: int = 104
    layer_norm_first: bool = True
    conv_pos: int = 128
    conv_pos_groups: int = 16
    modality_fuse: str = "concat"
    resnet_relu_type: str = "prelu"
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    dropout_input: float = 0.1
    layerdrop: float = 0.05
    lora_rank_divisor: Optional[int] = None
    lora_scaling: float = 2.0


def avhubert_large(use_lora: bool = True) -> AVHubertConfig:
    return AVHubertConfig(lora_rank_divisor=16 if use_lora else None)


def avhubert_base(use_lora: bool = True) -> AVHubertConfig:
    """AV-HuBERT Base: post-LN (`layer_norm_first=False`), which neither
    package's encoder runs (`models/avhubert.py::avhubert_encode` refuses it)."""
    return AVHubertConfig(
        encoder_embed_dim=768, encoder_layers=12, encoder_heads=12,
        encoder_ffn_dim=3072, layer_norm_first=False,
        lora_rank_divisor=16 if use_lora else None,
    )


@dataclass(frozen=True)
class OmniConfig:
    """The unified AVSR model (`Omni_AVSR/modeling_OmniAVSR.py:27-606`)."""

    llm_model: str = "meta-llama/Llama-3.2-1B"
    llm: LLMConfig = field(default_factory=llama32_1b)
    whisper: Optional[WhisperEncoderConfig] = field(default_factory=whisper_medium_en)
    avhubert: Optional[AVHubertConfig] = field(default_factory=avhubert_large)

    modality: str = "audiovisual"
    compression_mode: str = "avg-pooling"  # or "stack"
    fused_task_forward: bool = False
    # "pad30s" = reference-exact 30 s Whisper window; "bucket" computes only
    # the batch's bucketed window (the serving default of the bench)
    whisper_input_mode: str = "pad30s"
    downsample_ratio_audio: Tuple[int, ...] = (4, 16)
    downsample_ratio_video: Tuple[int, ...] = (2, 5)
    is_matryoshka: bool = True
    is_single_matry_projector: bool = False
    remove_layernorm_from_projector: bool = False
    projector_intermediate_size: int = 2048

    matry_weights: Optional[Tuple[float, float, float]] = (1.0, 1.5, 1.0)
    is_task_specific: bool = True
    use_shared_lora_task_specific: bool = False

    prompt_audio: str = "Transcribe speech to text."
    prompt_video: str = "Transcribe video to text."
    prompt_audiovisual: str = "Transcribe speech and video to text."

    max_dec_tokens: int = 32
    num_beams: int = 15

    @property
    def audio_rates(self) -> Tuple[int, ...]:
        return tuple(self.downsample_ratio_audio)

    @property
    def video_rates(self) -> Tuple[int, ...]:
        return tuple(self.downsample_ratio_video)


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer and schedule constants (`README.md:186-194`,
    `lightning_OmniAVSR.py:152-157`)."""

    lr: float = 1e-3
    weight_decay: float = 0.1
    betas: Tuple[float, float] = (0.9, 0.98)
    warmup_epochs: float = 0.0
    max_epochs: int = 8
    grad_clip: float = 10.0
    seed: int = 42
    num_checkpoints_to_average: int = 4
    log_every_steps: int = 50
    checkpoint_dir: str = "checkpoints"


@dataclass(frozen=True)
class DataConfig:
    """Data pipeline config (`datamodule/data_module.py:147-243`)."""

    root_dir: str = ""
    train_file: str = ""
    val_file: str = ""
    test_file: str = ""
    dataset_name: str = "lrs3"
    max_frames_audio: int = 1500
    max_frames_video: int = 1000
    max_frames_audiovisual: int = 1000
    train_num_buckets: int = 400
    num_workers: int = 5
    decode_snr_target: float = 999999.0
    # collation pads video to a multiple of this many frames and audio to
    # 640 samples per padded frame (16 kHz / 25 fps, `av_dataset.py:55`)
    video_pad_multiple: int = 32
    audio_samples_per_frame: int = 640


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh of the port (`parallel/mesh.py`; the JAX package's
    `MeshConfig`, `omni_avsr_tpu/config.py:371`), one rank per device.

    dp: data parallel (batch).  tp: tensor parallel (attention heads / MLP
    hidden).  pp: pipeline parallel (decoder layer stack, GPipe schedule,
    `parallel/pipeline.py`).  ep: expert parallel (MoE expert dim,
    `models/moe.py`). The dp and tp axes always exist in the mesh; pp and ep
    are added only when their size is > 1."""

    dp: int = 1
    tp: int = 1
    pp: int = 1
    ep: int = 1
    axis_dp: str = "dp"
    axis_tp: str = "tp"


def asdict(cfg: Any) -> Dict[str, Any]:
    """A config as nested plain dicts (`dataclasses.asdict`), as the JAX
    package's `config.py::asdict` writes it."""
    return dataclasses.asdict(cfg)
