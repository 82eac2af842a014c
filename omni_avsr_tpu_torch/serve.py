"""Serving API: raw media in, transcript out (port of the batched path of
`omni_avsr_tpu/serve.py` and the decode half of `train/engine.py`).

    from omni_avsr_tpu_torch.models.omni import flagship
    from omni_avsr_tpu_torch.serve import Transcriber

    t = Transcriber(model, params, quantize="int8")          # on "cuda"
    texts = t.transcribe_many([{"audio": wav16k, "video": frames}, ...])

Per request: eval-mode preprocessing, the gap-tolerant multimodal prefix,
one prefill, then beam search on the ancestor cache, whose attention is
the hand-written beam-decode kernel on the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .decode.decoding import beam_search
from .models.common import Params
from .models.omni import OmniAVSR
from .ops.audio_frontend import whisper_token_len
from .ops.augment import audio_pipeline, video_pipeline


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucket_ladder(n: int, base: int) -> int:
    """Smallest ladder class >= n: base, then ~1.5x steps rounded to base.
    Every member of a batch shares the padded window of its class."""
    v = base
    while v < n:
        v = _round_up(int(v * 1.5), base)
    return v


def _trainable(path: str) -> bool:
    """The leaves the JAX engine trains (projectors, LLM and AV-HuBERT
    LoRA); its serving tree carries them in bf16."""
    if path.startswith(("audio_proj", "video_proj")):
        return True
    return path.startswith(("llm.", "avhubert.")) and ".lora" in path


def merged_params(params: Params, dtype, device) -> Params:
    """The serving tree on `device`, its trainable leaves cast to the
    compute dtype as the JAX engine's `merged_params` does."""

    def walk(node, prefix):
        out = {}
        for k, v in node.items():
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = walk(v, path)
            elif _trainable(path) and v.is_floating_point():
                out[k] = v.to(device=device, dtype=dtype)
            else:
                out[k] = v.to(device)
        return out

    return walk(params, "")


VIDEO_PAD_MULTIPLE = 32  # frames; audio pads to 640 samples per frame


def pad_batch(items: Sequence[Dict[str, Optional[np.ndarray]]], modality: str):
    """Pad items to one bucket-class window -> (numpy batch, Whisper trim):
    video to its ladder class, audio to 640 samples per padded frame."""
    B = len(items)
    use_v = modality in ("video", "audiovisual")
    use_a = modality in ("audio", "audiovisual")
    batch: Dict[str, np.ndarray] = {}
    trim = 1500
    if use_v:
        Ts = [len(it["video"]) for it in items]
        Tp = bucket_ladder(max(Ts), VIDEO_PAD_MULTIPLE)
        v = np.zeros((B, Tp) + items[0]["video"].shape[1:], np.uint8)
        for b, it in enumerate(items):
            v[b, : Ts[b]] = it["video"]
        batch["video"] = v
        batch["video_len"] = np.asarray(Ts, np.int32)
    if use_a:
        Ss = [len(it["audio"]) for it in items]
        Sp = batch["video"].shape[1] * 640 if use_v else bucket_ladder(
            max(Ss), 640 * VIDEO_PAD_MULTIPLE)
        a = np.zeros((B, Sp), np.float32)
        for b, it in enumerate(items):
            s = min(Ss[b], Sp)
            a[b, :s] = it["audio"][:s]
        batch["audio"] = a
        batch["audio_len"] = np.asarray([min(s, Sp) for s in Ss], np.int32)
        trim = int(min(_round_up(whisper_token_len(Sp), 25), 1500))
    return batch, trim


class Transcriber:
    def __init__(
        self,
        model: OmniAVSR,
        params: Params,
        num_beams: Optional[int] = None,
        max_new_tokens: Optional[int] = None,
        quantize: Optional[str] = None,  # "int8": weight-only int8 decode weights
        device="cuda",
    ):
        self.model = model
        self.device = torch.device(device)
        self.params = merged_params(params, model.dtype, self.device)
        if quantize:
            from .ops.quant import quantize_for_decode

            self.params = quantize_for_decode(self.params, quantize)
        self.num_beams = num_beams if num_beams is not None else model.cfg.num_beams
        self.max_new = max_new_tokens if max_new_tokens is not None else model.cfg.max_dec_tokens
        self.last_decode_steps = 0  # decode steps of the last batch

    def decode_ids(self, batch: Dict[str, np.ndarray], modality: str, rate_audio: int,
                   rate_video: int, trim: int, num_beams: int) -> torch.Tensor:
        """Padded numpy batch -> (B, max_new) best-hypothesis ids."""
        model, tok, cfg = self.model, self.model.tok, self.model.cfg
        dev = self.device
        arrays = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        with torch.inference_mode():
            proc = dict(arrays)
            if "video" in arrays:
                proc["video"] = video_pipeline(arrays["video"], arrays["video_len"])
            if "audio" in arrays:
                proc["audio"] = audio_pipeline(arrays["audio"], arrays["audio_len"])
            prefix, key_valid = model.infer_prefix_masked(
                self.params, proc, modality, rate_audio, rate_video, trim)
            B, P0, _ = prefix.shape
            P = _round_up(P0, 16)
            prefix = torch.nn.functional.pad(prefix, (0, 0, 0, P - P0))
            key_valid = torch.nn.functional.pad(key_valid, (0, P - P0))
            lora_mod = modality if (cfg.llm.lora and cfg.llm.lora.task_specific) else None
            out = beam_search(
                self.params["llm"], cfg.llm, prefix, key_valid=key_valid,
                num_beams=num_beams, max_new=self.max_new, eos_id=tok.eos_id,
                pad_id=tok.pad_id, modality=lora_mod, cache_dtype=model.dtype)
        self.last_decode_steps = out.steps
        return out.tokens

    def transcribe_many(
        self,
        items: Sequence[Dict[str, Optional[np.ndarray]]],  # {"audio", "video"}
        modality: Optional[str] = None,
        rate_audio: Optional[int] = None,
        rate_video: Optional[int] = None,
        num_beams: Optional[int] = None,
    ) -> List[str]:
        """Pads every item to one shared bucket-class window and decodes them
        as one batch; per-sample token counts stay exact (the masked
        prefix). Items: audio (S,) f32 at 16 kHz, video (T, 96, 96, C) uint8."""
        assert items
        if modality is None:
            has_a = items[0].get("audio") is not None
            has_v = items[0].get("video") is not None
            modality = "audiovisual" if has_a and has_v else "audio" if has_a else "video"
        cfg = self.model.cfg
        rate_audio = rate_audio or cfg.audio_rates[0]
        rate_video = rate_video or cfg.video_rates[0]
        batch, trim = pad_batch(items, modality)
        ids = self.decode_ids(batch, modality, rate_audio, rate_video, trim,
                              num_beams if num_beams is not None else self.num_beams)
        tok = self.model.tok
        out = []
        for row in ids.cpu().tolist():
            toks = [t for t in row if t != tok.pad_id]
            if tok.eos_id in toks:
                toks = toks[: toks.index(tok.eos_id)]
            out.append(tok.decode(toks))
        return out
