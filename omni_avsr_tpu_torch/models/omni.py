"""The unified Omni-AVSR model on the decode path: encoders, matryoshka
compression, projectors and the decode prefix (port of the serving half of
`omni_avsr_tpu/models/omni.py`; reference `modeling_OmniAVSR.py:27-606`).

Decode prefix (Llama): [BOS][<audio> A </audio>][<video> V </video>][prompt],
per task. `infer_prefix_masked` keeps a static layout and masks each
sample's feature slots past its own token count, so a batched decode keeps
the reference's batch-size-1 semantics.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..config import (
    AVHubertConfig,
    LLMConfig,
    LoRAConfig,
    OmniConfig,
    WhisperEncoderConfig,
    avhubert_large,
    llama32_1b,
    whisper_medium_en,
)
from ..data.tokenizer import TokenizerBundle, synthetic_tokenizer
from ..ops.audio_frontend import log_mel_spectrogram, whisper_token_len
from ..ops.pooling import compress
from .avhubert import avhubert_encode
from .common import Params
from .llm import embed_tokens
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

    @property
    def _per_rate(self) -> bool:
        return self.cfg.is_matryoshka and not self.cfg.is_single_matry_projector

    def encode_audio(self, params: Params, audio: torch.Tensor, audio_len: torch.Tensor,
                     rate: int, trim_len: int) -> torch.Tensor:
        """(B, trim_len//rate, d_llm) projected audio tokens."""
        if self.cfg.whisper_input_mode == "bucket":
            mel = log_mel_spectrogram(audio, audio_len, num_frames=2 * trim_len)
        else:
            mel = log_mel_spectrogram(audio, audio_len)
        enc = whisper_encode(params["whisper"], self.cfg.whisper, mel.to(self.dtype))
        enc = compress(enc[:, :trim_len], rate, self.cfg.compression_mode)
        return project(params["audio_proj"], enc, rate if self._per_rate else None)

    def encode_video(self, params: Params, video: torch.Tensor, rate: int) -> torch.Tensor:
        enc = avhubert_encode(params["avhubert"], self.cfg.avhubert, video.to(self.dtype))
        enc = compress(enc, rate, self.cfg.compression_mode)
        return project(params["video_proj"], enc, rate if self._per_rate else None)

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
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(embeds (B, P, D), key_valid (B, P)) with per-sample exact audio
        and video token counts inside one static layout."""
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
            v = self.encode_video(params, batch["video"], rate_video).to(self.dtype)
            n_v = batch["video_len"] // rate_video
            const_valid(self._embed_id(params, tok.video_sos_id, B, dev))
            blocks.append(v)
            valids.append(torch.arange(v.shape[1], device=dev)[None] < n_v[:, None])
            const_valid(self._embed_id(params, tok.video_eos_id, B, dev))
        const_valid(self._prompt_embeds(params, modality, B, dev))
        return torch.cat(blocks, dim=1), torch.cat(valids, dim=1)


def flagship(tiny: bool, dtype=torch.bfloat16) -> OmniAVSR:
    """The flagship model of `__graft_entry__.py::_flagship`: Whisper-medium,
    ResNet3D + AV-HuBERT-Large and Llama-3.2-1B with task-specific
    Omni-LoRA (tiny=False), or its narrow test geometry (tiny=True); with
    the bucketed Whisper window of the serving bench."""
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
    cfg = dataclasses.replace(cfg, whisper_input_mode="bucket")
    return OmniAVSR(cfg, tok, dtype=dtype)
