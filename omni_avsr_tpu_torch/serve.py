"""Serving API: raw media in, transcript out (port of `omni_avsr_tpu/serve.py`
but for `from_pretrained` and `transcribe_file`, and of the decode half of
`train/engine.py`).

    from omni_avsr_tpu_torch.models.omni import flagship
    from omni_avsr_tpu_torch.serve import Transcriber

    t = Transcriber(model, params, quantize="int8")          # on "cuda"
    text = t.transcribe(audio=wav16k, video=frames)
    texts = t.transcribe_many([{"audio": wav16k, "video": frames}, ...])

`models/omni.py::registry_model` builds the model of any `LLM_REGISTRY`
name (Llama-3.x, Qwen2.5) with Whisper-medium and AV-HuBERT-Large.

Per request: eval-mode preprocessing, the gap-tolerant multimodal prefix,
one prefill, then beam search on the ancestor cache (greedy decoding on
the same cache with one beam when `num_beams <= 1`, as the JAX engine
routes it). On the card the
hand-written kernels carry it: beam-decode attention (B1) in every decode
step, the int8 or packed-int4 matmul (B2, B6) in every quantised linear,
and flash attention (B3) in the towers at long windows. Two opt-in
switches mirror the JAX package's: `select_kernel=True` (its
`OMNI_SELECT_KERNEL=1`) takes each beam step's selection statistics from
the stats kernel B5, and `conv_kernel=True` (its `OMNI_CONV_KERNEL=1`)
runs the ResNet trunk's 19 convs through the fused conv B7.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .decode.decoding import DecodeOutput, beam_search, greedy_decode
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


def merged_params(params: Params, dtype, device, is_trainable) -> Params:
    """The serving tree on `device`, the leaves `is_trainable` names (the
    model's `trainable_predicate`) cast to the compute dtype, as the JAX
    engine's `merged_params` does with its trainable tree."""

    def walk(node, prefix):
        out = {}
        for k, v in node.items():
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = walk(v, path)
            elif is_trainable(path) and v.is_floating_point():
                out[k] = v.to(device=device, dtype=dtype)
            else:
                out[k] = v.to(device)
        return out

    return walk(params, "")


VIDEO_PAD_MULTIPLE = 32  # frames, the default; audio pads to 640 samples per frame


def pad_batch(items: Sequence[Dict[str, Optional[np.ndarray]]], modality: str,
              video_pad_multiple: int = VIDEO_PAD_MULTIPLE):
    """Pad items to one bucket-class window -> (numpy batch, Whisper trim):
    video to its ladder class of `video_pad_multiple` frames, audio to 640
    samples per padded frame (to its own ladder class of 640 x
    `video_pad_multiple` samples when the modality has no video)."""
    B = len(items)
    use_v = modality in ("video", "audiovisual")
    use_a = modality in ("audio", "audiovisual")
    batch: Dict[str, np.ndarray] = {}
    trim = 1500
    if use_v:
        Ts = [len(it["video"]) for it in items]
        Tp = bucket_ladder(max(Ts), video_pad_multiple)
        v = np.zeros((B, Tp) + items[0]["video"].shape[1:], np.uint8)
        for b, it in enumerate(items):
            v[b, : Ts[b]] = it["video"]
        batch["video"] = v
        batch["video_len"] = np.asarray(Ts, np.int32)
    if use_a:
        Ss = [len(it["audio"]) for it in items]
        Sp = batch["video"].shape[1] * 640 if use_v else bucket_ladder(
            max(Ss), 640 * video_pad_multiple)
        a = np.zeros((B, Sp), np.float32)
        for b, it in enumerate(items):
            s = min(Ss[b], Sp)
            a[b, :s] = it["audio"][:s]
        batch["audio"] = a
        batch["audio_len"] = np.asarray([min(s, Sp) for s in Ss], np.int32)
        trim = int(min(_round_up(whisper_token_len(Sp), 25), 1500))
    return batch, trim


def given_modality(audio, video) -> str:
    """The modality of the streams given: both, audio or video."""
    return "audiovisual" if audio is not None and video is not None else (
        "audio" if audio is not None else "video")


def decode_padded(model: OmniAVSR, params: Params, batch: Dict[str, np.ndarray], modality: str,
                  rate_audio: int, rate_video: int, trim: int, num_beams: int, max_new: int,
                  device, *, select_kernel: bool = False, conv_kernel: bool = False,
                  noise_bank: Optional[torch.Tensor] = None, snr_target: Optional[float] = None,
                  generator: Optional[torch.Generator] = None) -> DecodeOutput:
    """The decode body that `Transcriber` and `OmniEngine.decode_batch`
    share (`omni_avsr_tpu/train/engine.py::_decode_fn`): eval preprocessing
    of the modality's streams (babble from `noise_bank` mixed at
    `snr_target`, its offsets from `generator`, when both are given), the
    gap-tolerant prefix padded to a multiple of 16 slots, one prefill, then
    beam search, or greedy decoding when `num_beams <= 1`. Returns the
    (B, max_new) ids and the decode steps run."""
    tok, cfg = model.tok, model.cfg
    use_a = modality in ("audio", "audiovisual")
    use_v = modality in ("video", "audiovisual")
    arrays = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    with torch.inference_mode():
        proc = dict(arrays)
        if use_v:
            proc["video"] = video_pipeline(arrays["video"], arrays["video_len"])
        if use_a:
            proc["audio"] = audio_pipeline(arrays["audio"], arrays["audio_len"],
                                           generator=generator, noise_bank=noise_bank,
                                           snr_target=snr_target)
        prefix, key_valid = model.infer_prefix_masked(
            params, proc, modality, rate_audio, rate_video, trim, conv_kernel=conv_kernel)
        P0 = prefix.shape[1]
        P = model.prefix_slots(modality, rate_audio, rate_video, trim,
                               batch["video"].shape[1] if use_v else 0)
        assert P == _round_up(P0, 16), (P, P0)
        prefix = torch.nn.functional.pad(prefix, (0, 0, 0, P - P0))
        key_valid = torch.nn.functional.pad(key_valid, (0, P - P0))
        lora_mod = modality if (cfg.llm.lora and cfg.llm.lora.task_specific) else None
        common = dict(key_valid=key_valid, max_new=max_new, eos_id=tok.eos_id,
                      pad_id=tok.pad_id, modality=lora_mod, cache_dtype=model.dtype)
        if num_beams <= 1:  # `omni_avsr_tpu/train/engine.py:311-318`
            return greedy_decode(params["llm"], cfg.llm, prefix, **common)
        return beam_search(params["llm"], cfg.llm, prefix, num_beams=num_beams,
                           select_kernel=select_kernel, **common)


def ids_to_texts(tok, ids: torch.Tensor) -> List[str]:
    """Each row's text: pads dropped, cut at the first EOS."""
    out = []
    for row in ids.cpu().tolist():
        toks = [t for t in row if t != tok.pad_id]
        if tok.eos_id in toks:
            toks = toks[: toks.index(tok.eos_id)]
        out.append(tok.decode(toks))
    return out


class Transcriber:
    def __init__(
        self,
        model: OmniAVSR,
        params: Params,
        num_beams: Optional[int] = None,
        max_new_tokens: Optional[int] = None,
        quantize: Optional[str] = None,  # "int8", or "int4" (packed LLM, int8 towers)
        device="cuda",
        select_kernel: bool = False,  # beam selection statistics through B5
        conv_kernel: bool = False,  # the ResNet trunk's convs through B7
        video_pad_multiple: int = VIDEO_PAD_MULTIPLE,  # frames: the ladder's base class
    ):
        self.model = model
        self.select_kernel = select_kernel
        self.conv_kernel = conv_kernel
        self.video_pad_multiple = video_pad_multiple
        self.device = torch.device(device)
        self.params = merged_params(params, model.dtype, self.device,
                                    model.trainable_predicate())
        if quantize:
            from .ops.quant import arrange_for_card, quantize_for_decode

            self.params = arrange_for_card(quantize_for_decode(self.params, quantize))
        self.num_beams = num_beams if num_beams is not None else model.cfg.num_beams
        self.max_new = max_new_tokens if max_new_tokens is not None else model.cfg.max_dec_tokens
        self.last_decode_steps = 0  # decode steps of the last batch

    def decode_ids(self, batch: Dict[str, np.ndarray], modality: str, rate_audio: int,
                   rate_video: int, trim: int, num_beams: int) -> torch.Tensor:
        """Padded numpy batch -> (B, max_new) ids: the best beam hypothesis,
        or the greedy ids when `num_beams <= 1`."""
        out = decode_padded(self.model, self.params, batch, modality, rate_audio, rate_video,
                            trim, num_beams, self.max_new, self.device,
                            select_kernel=self.select_kernel, conv_kernel=self.conv_kernel)
        self.last_decode_steps = out.steps
        return out.tokens

    def _rates(self, rate_audio: Optional[int], rate_video: Optional[int]):
        cfg = self.model.cfg
        return rate_audio or cfg.audio_rates[0], rate_video or cfg.video_rates[0]

    def transcribe(
        self,
        audio: Optional[np.ndarray] = None,  # (S,) f32 at 16 kHz
        video: Optional[np.ndarray] = None,  # (T, 96, 96, C) uint8 mouth frames
        modality: Optional[str] = None,
        rate_audio: Optional[int] = None,
        rate_video: Optional[int] = None,
        num_beams: Optional[int] = None,
    ) -> str:
        """One request, padded as the JAX `Transcriber.transcribe` pads it
        (`omni_avsr_tpu/serve.py:166-210`): by the streams given, whatever
        the modality, so with both given the audio pads to the padded
        video's length even when `modality="audio"`."""
        assert audio is not None or video is not None
        given = given_modality(audio, video)
        modality = modality or given
        rate_audio, rate_video = self._rates(rate_audio, rate_video)
        batch, trim = pad_batch([{"audio": audio, "video": video}], given,
                                self.video_pad_multiple)
        ids = self.decode_ids(batch, modality, rate_audio, rate_video, trim,
                              num_beams if num_beams is not None else self.num_beams)
        return ids_to_texts(self.model.tok, ids)[0]

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
        modality = modality or given_modality(items[0].get("audio"), items[0].get("video"))
        rate_audio, rate_video = self._rates(rate_audio, rate_video)
        batch, trim = pad_batch(items, modality, self.video_pad_multiple)
        ids = self.decode_ids(batch, modality, rate_audio, rate_video, trim,
                              num_beams if num_beams is not None else self.num_beams)
        return ids_to_texts(self.model.tok, ids)

    def bucket_class(self, item: Dict[str, Optional[np.ndarray]], modality: str) -> Tuple[str, int]:
        """The padded-window class the item decodes at alone
        (`omni_avsr_tpu/serve.py:272-281`): requests grouped by it decode
        in one batch exactly as they would alone."""
        if modality in ("video", "audiovisual"):
            return ("v", bucket_ladder(len(item["video"]), self.video_pad_multiple))
        return ("a", bucket_ladder(len(item["audio"]), 640 * self.video_pad_multiple))
