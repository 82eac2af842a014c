"""Typed configuration for the PyTorch port.

A copy of the dataclasses of `omni_avsr_tpu/config.py` that the serving
and training slices need (the port imports nothing of the JAX package). Field names,
defaults and the published geometries are the same, so a config built here
describes the same model as its JAX twin.

  - LLM hidden sizes: `Omni_AVSR/lightning_OmniAVSR.py:28-37`
  - LoRA geometry: `Omni_AVSR/Llama_LoRA.py:103-230` (RANK is a reduction
    divisor: bottleneck = round(hidden / RANK), scaling = ALPHA / RANK)
  - AV-HuBERT Large: 24 layers / 1024 dim (`av_hubert/avhubert/hubert.py`)
  - Whisper medium.en encoder: 24 layers / 1024 dim / 16 heads
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

MODALITIES: Tuple[str, ...] = ("audio", "video", "audiovisual")


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
    """Decoder-only LLM config (Llama-3.x geometry; Qwen fields kept)."""

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
