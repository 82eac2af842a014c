"""The unified Omni-AVSR model: encoders, matryoshka compression,
projectors, the three-task training forward and the decode prefix (port of
`omni_avsr_tpu/models/omni.py`; reference `modeling_OmniAVSR.py:27-606`).

Sequences (Llama; Qwen drops the BOS and appends the text after the
prompt), per task, with the task's subset of A and V:
  train  : [BOS][<audio> A </audio>][<video> V </video>][prompt][text EOS]
  labels : [bos ][-100 ...                                    ][text EOS]
  infer  : [BOS][<audio> A </audio>][<video> V </video>][prompt]
`infer_prefix_masked` keeps a static layout and masks each sample's feature
slots past its own token count, so a batched decode keeps the reference's
batch-size-1 semantics; `infer_prefix` is the contiguous prefix, every
sample at the batch's padded token counts. `train_losses` runs the three
tasks one after the other, or stacked in one decoder forward when
`cfg.fused_task_forward` (`_fused_train_losses`); `single_task_loss` is
the Llama-AVSR baseline's one-task loss.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import (
    LLM_REGISTRY,
    MODALITIES,
    AVHubertConfig,
    LLMConfig,
    LoRAConfig,
    OmniConfig,
    WhisperEncoderConfig,
    avhubert_large,
    default_v_divisor,
    llama32_1b,
    whisper_medium_en,
)
from ..data.tokenizer import IGNORE_INDEX, TokenizerBundle, synthetic_tokenizer
from ..ops.audio_frontend import log_mel_spectrogram, whisper_token_len
from ..ops.pooling import compress
from ..parallel.collectives import global_count
from .avhubert import avhubert_encode, layers_to_run
from .common import Params
from .llm import (FUSED3, embed_tokens, gather_vocab, llm_backbone, llm_span_stats, lm_head,
                  token_ce_stats)
from .projector import project
from .whisper import whisper_encode


class OmniAVSR:
    """Host-side model handle: static config, tokenizer constants and the
    compute dtype (bf16, as the JAX package hard-codes; f32 for parity
    tests that must not let bf16 rounding decide beam ties)."""

    def __init__(self, cfg: OmniConfig, tok: TokenizerBundle, dtype=torch.bfloat16):
        assert tok.family == cfg.llm.family
        self.cfg = cfg
        self.tok = tok
        self.dtype = dtype
        self.prompt_ids = {
            "audio": tok.prompt_ids(cfg.prompt_audio),
            "video": tok.prompt_ids(cfg.prompt_video),
            "audiovisual": tok.prompt_ids(cfg.prompt_audiovisual),
        }
        self.last_video_layers = 0  # AV-HuBERT layers the last video forward ran

    def trainable_predicate(self, unfrozen_modules: Tuple[str, ...] = ("peft_llm", "lora_avhubert")
                            ) -> Callable[[str], bool]:
        """Path predicate of the trainable/frozen split (`_unfreeze_PETF`,
        `modeling_OmniAVSR.py:234-260`; `omni_avsr_tpu/models/omni.py:87-118`):
        projectors always train; the LLM's LoRA iff "peft_llm"; AV-HuBERT's
        LoRA iff "lora_avhubert"; the whole decoder iff "full_llm" and the
        whole of both towers iff "full_towers" (not reference recipes: the
        JAX package's WER probe trains them so that a tiny model can
        memorise its clips)."""

        def pred(path: str) -> bool:
            if path.startswith(("audio_proj", "video_proj")):
                return True
            if "full_llm" in unfrozen_modules and path.startswith("llm."):
                return True
            if "full_towers" in unfrozen_modules and path.startswith(("whisper.", "avhubert.")):
                return True
            if "peft_llm" in unfrozen_modules and path.startswith("llm.") and ".lora" in path:
                return True
            return ("lora_avhubert" in unfrozen_modules and path.startswith("avhubert.")
                    and ".lora" in path)

        return pred

    @property
    def _per_rate(self) -> bool:
        return self.cfg.is_matryoshka and not self.cfg.is_single_matry_projector

    def audio_features(self, params: Params, audio: torch.Tensor, audio_len: torch.Tensor,
                       trim_len: int) -> torch.Tensor:
        """(B, trim_len, d_whisper): Whisper over the log-mel of the
        preprocessed audio, trimmed."""
        if self.cfg.whisper_input_mode == "bucket":
            mel = log_mel_spectrogram(audio, audio_len, num_frames=2 * trim_len)
        else:
            mel = log_mel_spectrogram(audio, audio_len)
        enc = whisper_encode(params["whisper"], self.cfg.whisper, mel.to(self.dtype))
        return enc[:, :trim_len]

    def project_audio(self, params: Params, enc: torch.Tensor, rate: int) -> torch.Tensor:
        """(B, T//rate, d_llm): Whisper features compressed at `rate` and
        projected."""
        enc = compress(enc, rate, self.cfg.compression_mode)
        return project(params["audio_proj"], enc, rate if self._per_rate else None)

    def encode_audio(self, params: Params, audio: torch.Tensor, audio_len: torch.Tensor,
                     rate: int, trim_len: int) -> torch.Tensor:
        """(B, trim_len//rate, d_llm) projected audio tokens."""
        return self.project_audio(params, self.audio_features(params, audio, audio_len,
                                                              trim_len), rate)

    def video_features(self, params: Params, video: torch.Tensor, train_mode: bool = False,
                       generator=None, conv_kernel: bool = False, bn_stats: str = "onepass",
                       remat: str = "off") -> torch.Tensor:
        """(B, T, d_avhubert): AV-HuBERT over the preprocessed video;
        `train_mode` runs the ResNet's BN on batch statistics (`bn_stats`:
        "onepass" or "twopass"), `generator` (a torch.Generator or a
        threefry key) AV-HuBERT's dropouts and layerdrop
        (`models/avhubert.py`), `conv_kernel` the ResNet trunk's convs
        through B7, `remat` the encoder layers' remat policy."""
        plan = layers_to_run(self.cfg.avhubert, generator)
        self.last_video_layers = len(plan[0])
        return avhubert_encode(params["avhubert"], self.cfg.avhubert, video.to(self.dtype),
                               train_mode=train_mode, generator=generator, plan=plan,
                               conv_kernel=conv_kernel, bn_stats=bn_stats, remat=remat)

    def project_video(self, params: Params, enc: torch.Tensor, rate: int) -> torch.Tensor:
        """(B, T//rate, d_llm): AV-HuBERT features compressed at `rate` and
        projected."""
        enc = compress(enc, rate, self.cfg.compression_mode)
        return project(params["video_proj"], enc, rate if self._per_rate else None)

    def encode_video(self, params: Params, video: torch.Tensor, rate: int,
                     train_mode: bool = False, generator=None, conv_kernel: bool = False,
                     dropout_rng: Optional[torch.Tensor] = None, bn_stats: str = "onepass",
                     remat: str = "off") -> torch.Tensor:
        """(B, T//rate, d_llm) projected video tokens (`video_features`);
        `dropout_rng`, a threefry key, takes the place of `generator`
        (`omni_avsr_tpu/models/omni.py:141-154`)."""
        rng = dropout_rng if dropout_rng is not None else generator
        return self.project_video(params, self.video_features(
            params, video, train_mode, rng, conv_kernel, bn_stats, remat), rate)

    def prefix_slots(self, modality: str, rate_audio: int, rate_video: int, trim: int,
                     video_frames: int) -> int:
        """The decode prefix's slot count, rounded up to 16 as the decoder
        pads it, for a batch whose Whisper window is trimmed to `trim`
        tokens and whose video is padded to `video_frames`: BOS, each
        modality's tokens between its two delimiters, and the prompt
        (`infer_prefix_masked`)."""
        n = int(self.cfg.llm.family == "llama") + len(self.prompt_ids[modality])
        if modality in ("audio", "audiovisual"):
            n += 2 + trim // rate_audio
        if modality in ("video", "audiovisual"):
            n += 2 + video_frames // rate_video
        return -(-n // 16) * 16

    def infer_prefix(self, params: Params, batch: Dict[str, torch.Tensor], modality: str,
                     rate_audio: Optional[int] = None, rate_video: Optional[int] = None,
                     audio_trim_len: Optional[int] = None,
                     conv_kernel: bool = False) -> torch.Tensor:
        """The contiguous decode prefix [BOS][<audio> A </audio>][<video> V
        </video>][prompt] (B, P, D), every sample at the batch's padded
        token counts (`omni_avsr_tpu/models/omni.py:376-407`; reference
        `modeling_OmniAVSR.py:397-458`). Its length goes to the decoder as
        `prefix_len`."""
        key = "audio" if "audio" in batch else "video"
        B, dev = batch[key].shape[0], batch[key].device
        tok = self.tok
        blocks = []
        if self.cfg.llm.family == "llama":
            blocks.append(self._embed_id(params, tok.bos_id, B, dev))
        if modality in ("audio", "audiovisual"):
            a = self.encode_audio(params, batch["audio"], batch["audio_len"], rate_audio,
                                  audio_trim_len).to(self.dtype)
            blocks += [self._embed_id(params, tok.audio_sos_id, B, dev), a,
                       self._embed_id(params, tok.audio_eos_id, B, dev)]
        if modality in ("video", "audiovisual"):
            v = self.encode_video(params, batch["video"], rate_video,
                                  conv_kernel=conv_kernel).to(self.dtype)
            blocks += [self._embed_id(params, tok.video_sos_id, B, dev), v,
                       self._embed_id(params, tok.video_eos_id, B, dev)]
        blocks.append(self._prompt_embeds(params, modality, B, dev))
        return torch.cat(blocks, dim=1)

    def _embed_id(self, params: Params, tid: int, B: int, device) -> torch.Tensor:
        ids = torch.full((B, 1), tid, dtype=torch.long, device=device)
        return embed_tokens(params["llm"], ids, self.dtype)

    def _prompt_embeds(self, params: Params, modality: str, B: int, device) -> torch.Tensor:
        ids = torch.as_tensor(self.prompt_ids[modality], dtype=torch.long, device=device)[None]
        emb = embed_tokens(params["llm"], ids, self.dtype)
        return emb.expand(B, *emb.shape[1:])

    def infer_prefix_masked(
        self,
        params: Params,
        batch: Dict[str, torch.Tensor],
        modality: str,
        rate_audio: Optional[int] = None,
        rate_video: Optional[int] = None,
        audio_trim_max: Optional[int] = None,
        conv_kernel: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(embeds (B, P, D), key_valid (B, P)) with per-sample exact audio
        and video token counts inside one static layout; `conv_kernel` runs
        the ResNet trunk's convs through B7."""
        key = "audio" if "audio" in batch else "video"
        B = batch[key].shape[0]
        dev = batch[key].device
        tok = self.tok
        blocks, valids = [], []

        def const_valid(x):
            blocks.append(x)
            valids.append(torch.ones((B, x.shape[1]), dtype=torch.bool, device=dev))

        if self.cfg.llm.family == "llama":
            const_valid(self._embed_id(params, tok.bos_id, B, dev))
        if modality in ("audio", "audiovisual"):
            a = self.encode_audio(params, batch["audio"], batch["audio_len"], rate_audio,
                                  audio_trim_max).to(self.dtype)
            n_a = whisper_token_len(batch["audio_len"]) // rate_audio
            const_valid(self._embed_id(params, tok.audio_sos_id, B, dev))
            blocks.append(a)
            valids.append(torch.arange(a.shape[1], device=dev)[None] < n_a[:, None])
            const_valid(self._embed_id(params, tok.audio_eos_id, B, dev))
        if modality in ("video", "audiovisual"):
            v = self.encode_video(params, batch["video"], rate_video,
                                  conv_kernel=conv_kernel).to(self.dtype)
            n_v = batch["video_len"] // rate_video
            const_valid(self._embed_id(params, tok.video_sos_id, B, dev))
            blocks.append(v)
            valids.append(torch.arange(v.shape[1], device=dev)[None] < n_v[:, None])
            const_valid(self._embed_id(params, tok.video_eos_id, B, dev))
        const_valid(self._prompt_embeds(params, modality, B, dev))
        return torch.cat(blocks, dim=1), torch.cat(valids, dim=1)


    def _assemble_task(self, params: Params, modality: str, av_parts: Tuple[torch.Tensor, ...],
                       text_emb: torch.Tensor, labels: torch.Tensor):
        """(embeds, labels with the IGNORE prefix, span) of one task's
        training sequence, `span` the static [t0, t1) window of logits
        positions whose shifted targets can be real
        (`omni_avsr_tpu/models/omni.py:181-227`)."""
        B, dev = text_emb.shape[0], text_emb.device
        blocks = []
        if modality in ("audio", "audiovisual"):
            blocks += [self._embed_id(params, self.tok.audio_sos_id, B, dev), av_parts[0],
                       self._embed_id(params, self.tok.audio_eos_id, B, dev)]
        if modality in ("video", "audiovisual"):
            blocks += [self._embed_id(params, self.tok.video_sos_id, B, dev), av_parts[-1],
                       self._embed_id(params, self.tok.video_eos_id, B, dev)]
        blocks.append(self._prompt_embeds(params, modality, B, dev))
        prefix = torch.cat(blocks, dim=1)
        P, Tt = prefix.shape[1], text_emb.shape[1]
        ignore = torch.full((B, P), IGNORE_INDEX, dtype=labels.dtype, device=dev)
        if self.cfg.llm.family == "llama":
            # [BOS | prefix (P) | text (Tt-1)]: the first real target is labels[:, 1]
            # at sequence index P + 1, so the logits span is [P, P + Tt - 1)
            embeds = torch.cat([text_emb[:, :1], prefix, text_emb[:, 1:]], dim=1)
            lab = torch.cat([labels[:, :1], ignore, labels[:, 1:]], dim=1)
            return embeds, lab, (P, P + Tt - 1)
        # qwen, no BOS: [prefix (P) | text (Tt)]: the first target labels[:, 0]
        # sits at sequence index P, so the logits span is [P - 1, P + Tt - 1)
        embeds = torch.cat([prefix, text_emb], dim=1)
        return embeds, torch.cat([ignore, labels], dim=1), (P - 1, P + Tt - 1)

    def train_losses(self, params: Params, batch: Dict[str, torch.Tensor], rate_audio: int,
                     rate_video: int, audio_trim_len: int, train_mode: bool = True,
                     remat: str = "dots", generator: Optional[torch.Generator] = None,
                     conv_kernel: bool = False, dropout_rng: Optional[torch.Tensor] = None,
                     bn_stats: str = "onepass", pipeline=None) -> Dict[str, torch.Tensor]:
        """Three-task training forward: the matryoshka-weighted CE of each
        task (`modeling_OmniAVSR.py:263-306`;
        `omni_avsr_tpu/models/omni.py:233-280`, its unfused route). Batch:
        preprocessed audio/audio_len/video, tokens and labels (B, Tt).
        `train_mode` runs the ResNet's BN on batch statistics (`bn_stats`);
        `generator`, or the threefry key `dropout_rng`, AV-HuBERT's dropouts
        and layerdrop; `conv_kernel` the ResNet trunk's convs through B7;
        `remat` is the remat policy of the LLM's and AV-HuBERT's layers
        ("dots", "off" or "full": the same values); `pipeline` a
        `PipelinePlan` for the decoder stack. Inside a data-parallel step
        (`parallel/collectives.py`) each CE is this rank's sum over the
        global token count, so the ranks' losses sum to the global one."""
        cfg, dtype = self.cfg, self.dtype
        text_emb = embed_tokens(params["llm"], batch["tokens"].long(), dtype)
        labels = batch["labels"]
        # video first: with a generator its layer plan is a host sync
        # (`layers_to_run`), which then waits for the preprocessing only
        v = self.encode_video(params, batch["video"], rate_video, train_mode, generator,
                              conv_kernel, dropout_rng, bn_stats, remat).to(dtype)
        a = self.encode_audio(params, batch["audio"], batch["audio_len"], rate_audio,
                              audio_trim_len).to(dtype)
        task_specific = bool(cfg.llm.lora and cfg.llm.lora.task_specific)
        if cfg.fused_task_forward:
            return self._fused_train_losses(params, a, v, text_emb, labels, task_specific, remat,
                                            pipeline)
        losses = {}
        for i, m in enumerate(MODALITIES):
            parts = {"audio": (a,), "video": (v,), "audiovisual": (a, v)}[m]
            embeds, lab, span = self._assemble_task(params, m, parts, text_emb, labels)
            total, count = llm_span_stats(params["llm"], cfg.llm, embeds, lab, span,
                                          modality=m if task_specific else None, remat=remat,
                                          pipeline=pipeline)
            loss = total.sum() / torch.clamp(global_count(count.sum()), min=1)
            if cfg.matry_weights is not None:
                loss = loss * cfg.matry_weights[i]
            losses[m] = loss
        return losses

    def _fused_train_losses(self, params: Params, a: torch.Tensor, v: torch.Tensor,
                            text_emb: torch.Tensor, labels: torch.Tensor, task_specific: bool,
                            remat: str, pipeline=None) -> Dict[str, torch.Tensor]:
        """The three tasks in one LLM forward, stacked on the batch axis
        (`omni_avsr_tpu/models/omni.py:282-335`): each task's sequence is
        right-padded to the longest (the audiovisual one), the decoder runs
        one (3B, T_max) stack with each block's own adapter (`FUSED3`), then
        one lm_head over the three label spans (each Tt wide at its task's
        offset) and one CE. Causal masking keeps the padded tail out of
        every real position, so the losses equal the unfused ones."""
        cfg = self.cfg
        B = text_emb.shape[0]
        tasks = [self._assemble_task(params, m, {"audio": (a,), "video": (v,),
                                                 "audiovisual": (a, v)}[m], text_emb, labels)
                 for m in MODALITIES]
        T_max = max(e.shape[1] for e, _, _ in tasks)
        stacked = torch.cat([F.pad(e, (0, 0, 0, T_max - e.shape[1])) for e, _, _ in tasks])
        positions = torch.arange(T_max, device=stacked.device)[None].expand(3 * B, T_max)
        x = llm_backbone(params["llm"], cfg.llm, stacked, positions,
                         FUSED3 if task_specific else None, remat, pipeline)
        rows = torch.cat([x[i * B:(i + 1) * B, t0:t1] for i, (_, _, (t0, t1)) in enumerate(tasks)])
        targets = torch.cat([lab[:, t0 + 1:t1 + 1] for _, lab, (t0, t1) in tasks])
        total, count = token_ce_stats(gather_vocab(lm_head(params["llm"], cfg.llm, rows),
                                                   cfg.llm), targets)
        losses = {}
        for i, m in enumerate(MODALITIES):
            loss = total[i * B:(i + 1) * B].sum() / torch.clamp(
                global_count(count[i * B:(i + 1) * B].sum()), min=1)
            if cfg.matry_weights is not None:
                loss = loss * cfg.matry_weights[i]
            losses[m] = loss
        return losses

    def task_features(self, params: Params, batch: Dict[str, torch.Tensor], modality: str,
                      audio_trim_len: Optional[int], train_mode: bool = True,
                      generator: Optional[torch.Generator] = None,
                      conv_kernel: bool = False, dropout_rng: Optional[torch.Tensor] = None,
                      bn_stats: str = "onepass", remat: str = "off") -> Dict[str, torch.Tensor]:
        """The encoder features a task reads, before compression: "audio"
        (Whisper, trimmed) and/or "video" (AV-HuBERT, its random source
        `dropout_rng` or `generator`), in the compute dtype."""
        feats = {}
        if modality in ("video", "audiovisual"):  # first: its layer plan is a host sync
            rng = dropout_rng if dropout_rng is not None else generator
            feats["video"] = self.video_features(params, batch["video"], train_mode, rng,
                                                 conv_kernel, bn_stats, remat).to(self.dtype)
        if modality in ("audio", "audiovisual"):
            feats["audio"] = self.audio_features(params, batch["audio"], batch["audio_len"],
                                                 audio_trim_len).to(self.dtype)
        return feats

    def single_task_loss(self, params: Params, batch: Dict[str, torch.Tensor], modality: str,
                         features: Dict[str, torch.Tensor], rate_audio: Optional[int] = None,
                         rate_video: Optional[int] = None, remat: str = "dots",
                         pipeline=None) -> torch.Tensor:
        """The Llama-AVSR baseline's loss: one task's CE at one pair of rates
        (`omni_avsr_tpu/models/omni.py:337-374`; reference
        `modeling_LlamaAVSR.py`), on `features`, the `task_features` of the
        same batch: the Llama-MTSK step encodes once for all its rate
        combos, and the encoders' random draws (`dropout_rng` or
        `generator`) are taken there."""
        cfg, dtype = self.cfg, self.dtype
        text_emb = embed_tokens(params["llm"], batch["tokens"].long(), dtype)
        parts = []
        if modality in ("audio", "audiovisual"):
            parts.append(self.project_audio(params, features["audio"], rate_audio).to(dtype))
        if modality in ("video", "audiovisual"):
            parts.append(self.project_video(params, features["video"], rate_video).to(dtype))
        embeds, lab, span = self._assemble_task(params, modality, tuple(parts), text_emb,
                                                batch["labels"])
        lora_mod = modality if (cfg.llm.lora and cfg.llm.lora.task_specific) else None
        total, count = llm_span_stats(params["llm"], cfg.llm, embeds, lab, span,
                                      modality=lora_mod, remat=remat, pipeline=pipeline)
        return total.sum() / torch.clamp(global_count(count.sum()), min=1)


def flagship(tiny: bool, dtype=torch.bfloat16, whisper_input_mode: str = "pad30s") -> OmniAVSR:
    """The flagship model of `__graft_entry__.py::_flagship`: Whisper-medium,
    ResNet3D + AV-HuBERT-Large and Llama-3.2-1B with task-specific
    Omni-LoRA (tiny=False), or its narrow test geometry (tiny=True). The
    Whisper window is the config's default 30 s one ("pad30s"), as there;
    the serving bench passes "bucket" (`bench.py:54`)."""
    if tiny:
        tok = synthetic_tokenizer("llama", base_vocab=505)
        llm = LLMConfig(
            vocab_size=tok.vocab_size, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=8, num_kv_heads=4, head_dim=16,
            lora=LoRAConfig(rank_divisor=8, alpha=4, task_specific=True, v_out_divisor=2),
        )
        cfg = OmniConfig(
            llm=llm,
            whisper=WhisperEncoderConfig(hidden_size=64, num_layers=2, num_heads=4, ffn_dim=128),
            avhubert=AVHubertConfig(
                encoder_embed_dim=64, encoder_layers=2, encoder_heads=4,
                encoder_ffn_dim=128, audio_feat_dim=26, lora_rank_divisor=16,
            ),
            projector_intermediate_size=32,
        )
    else:
        tok = synthetic_tokenizer("llama", base_vocab=128254)
        lora = LoRAConfig(rank_divisor=32, alpha=4, task_specific=True, v_out_divisor=4)
        cfg = OmniConfig(
            llm=llama32_1b(lora=lora, vocab_size=tok.vocab_size),
            whisper=whisper_medium_en(),
            avhubert=avhubert_large(),
        )
    if whisper_input_mode not in ("pad30s", "bucket"):
        raise ValueError(f"whisper_input_mode {whisper_input_mode!r}")
    cfg = dataclasses.replace(cfg, whisper_input_mode=whisper_input_mode)
    return OmniAVSR(cfg, tok, dtype=dtype)


def registry_model(llm_model: str, tok: TokenizerBundle, dtype=torch.bfloat16,
                   whisper_input_mode: str = "pad30s") -> OmniAVSR:
    """The model of an `LLM_REGISTRY` name (Llama-3.2-1B/3B, Llama-3.1-8B,
    Qwen2.5 0.5B-32B) with Whisper-medium and AV-HuBERT-Large: the
    configuration the JAX `Transcriber.from_pretrained` builds when it is
    given no config (`omni_avsr_tpu/serve.py:119-132`), task-specific
    Omni-LoRA with the model's V divisor, the LLM at `tok`'s vocabulary."""
    if tok.family != ("qwen" if "Qwen" in llm_model else "llama"):
        raise ValueError(f"a {tok.family} tokenizer for {llm_model}")
    if whisper_input_mode not in ("pad30s", "bucket"):
        raise ValueError(f"whisper_input_mode {whisper_input_mode!r}")
    lora = LoRAConfig(rank_divisor=32, alpha=4, task_specific=True,
                      v_out_divisor=default_v_divisor(llm_model))
    cfg = OmniConfig(
        llm_model=llm_model,
        llm=LLM_REGISTRY[llm_model](lora=lora, vocab_size=tok.vocab_size),
        whisper=whisper_medium_en(), avhubert=avhubert_large(),
        whisper_input_mode=whisper_input_mode,
    )
    return OmniAVSR(cfg, tok, dtype=dtype)
