"""Serving API: raw media in, transcript out (port of `omni_avsr_tpu/serve.py`,
and of the decode half of `train/engine.py`).

    from omni_avsr_tpu_torch.models.omni import flagship
    from omni_avsr_tpu_torch.serve import Transcriber

    t = Transcriber(model, params, quantize="int8")          # on "cuda"
    t = Transcriber.from_pretrained("omni.pth", tokenizer=tok, quantize="int8")
    text = t.transcribe(audio=wav16k, video=frames)
    texts = t.transcribe_many([{"audio": wav16k, "video": frames}, ...])
    text = t.transcribe_file("clip.npy")   # raw frames + clip.wav: mouth ROIs first

`models/omni.py::registry_model` builds the model of any `LLM_REGISTRY`
name (Llama-3.x, Qwen2.5) with Whisper-medium and AV-HuBERT-Large.

Per request: eval-mode preprocessing, the gap-tolerant multimodal prefix,
one prefill, then beam search (greedy decoding with one beam when
`num_beams <= 1`, as the JAX engine routes it). On the card the
hand-written kernels carry it: beam-decode attention (B1) in every decode
step, the int8 or packed-int4 matmul (B2, B6) in every quantised linear,
and flash attention (B3) in the towers at long windows. Two opt-in
switches mirror the JAX package's: `select_kernel=True` (its
`OMNI_SELECT_KERNEL=1`) takes each beam step's selection statistics from
the stats kernel B5, and `conv_kernel=True` (its `OMNI_CONV_KERNEL=1`)
runs the ResNet trunk's 19 convs through the fused conv B7. The decode's
numerics switches are arguments too: `attn_route="xla"` takes the JAX
package's reorder route (its `OMNI_BEAM_ATTN=xla`; also the route at a
head size B1 lacks), `select_mode="grid"` its full candidate grid
(`OMNI_BEAM_SELECT=grid`), and `no_repeat_ngram_size` bans repeated
n-grams.

With `mesh` (a tp `DeviceMesh`, `parallel/mesh.py`) every rank of the mesh
builds its own shard of the serving tree (`decode_partition_specs`: the
LLM matmuls and the encoder FFNs over tp, int8 codes and scales sliced
from the whole tree bit for bit, then fused and laid out for the card per
rank) and runs the same requests: B1 on its heads, B2 on its slices, B5
on its vocabulary slice with an exact merge; every rank returns the same
transcripts (`omni_avsr_tpu/serve.py:54-101`).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import OmniConfig
from .data.tokenizer import TokenizerBundle
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


def placer(dtype, device, is_trainable):
    """`place(path, leaf)` of the serving tree: the leaf on `device`, the
    leaves `is_trainable` names (the model's `trainable_predicate`) cast to
    the compute dtype, as the JAX engine's `merged_params` does with its
    trainable tree."""

    def place(path: str, v: torch.Tensor) -> torch.Tensor:
        if is_trainable(path) and v.is_floating_point():
            return v.to(device=device, dtype=dtype)
        return v.to(device)

    return place


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
                  generator=None, attn_route: Optional[str] = None,
                  select_mode: str = "fused", no_repeat_ngram_size: int = 0,
                  attn_mesh=None) -> DecodeOutput:
    """The decode body that `Transcriber` and `OmniEngine.decode_batch`
    share (`omni_avsr_tpu/train/engine.py::_decode_fn`): eval preprocessing
    of the modality's streams (babble from `noise_bank` mixed at
    `snr_target`, its offsets from `generator`, a torch.Generator or a
    threefry key, when both are given), the gap-tolerant prefix padded to a
    multiple of 16 slots, one prefill, then beam search, or greedy decoding
    when `num_beams <= 1`, on the attention route `attn_route`
    (`decode/decoding.py::decode_route`) with the candidate selection
    `select_mode` and the n-gram ban `no_repeat_ngram_size` (beam search
    only). Returns the (B, max_new) ids and the decode steps run."""
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
                      pad_id=tok.pad_id, modality=lora_mod, cache_dtype=model.dtype,
                      attn_route=attn_route)
        if num_beams <= 1:  # `omni_avsr_tpu/train/engine.py:311-318`
            return greedy_decode(params["llm"], cfg.llm, prefix, **common)
        return beam_search(params["llm"], cfg.llm, prefix, num_beams=num_beams,
                           select_kernel=select_kernel, select_mode=select_mode,
                           no_repeat_ngram_size=no_repeat_ngram_size, attn_mesh=attn_mesh,
                           **common)


def ids_to_texts(tok, ids: torch.Tensor) -> List[str]:
    """Each row's text: pads dropped, cut at the first EOS."""
    out = []
    for row in ids.cpu().tolist():
        toks = [t for t in row if t != tok.pad_id]
        if tok.eos_id in toks:
            toks = toks[: toks.index(tok.eos_id)]
        out.append(tok.decode(toks))
    return out


def shard_serving_tree(tree: Params, mesh, quantized: bool, replicate=(),
                       coords: Optional[Dict[str, int]] = None):
    """(local tree, tp blocks): one rank's shard of a placed serving tree,
    whose int8 leaves (when `quantized`) are not yet fused. Cut by
    `decode_partition_specs`, clamped to the shapes and made coherent per
    block (`parallel/partitioning.py`; the blocks of `replicate` run
    replicated); then q|k|v and gate|up fused and every int8 leaf laid out
    for the card. `mesh` may be a mapping of axis sizes, and `coords` (the
    rank's mesh coordinates, else its own) lets one process cut every
    rank's shard."""
    from .ops.quant import arrange_for_card, fuse_decode_projections
    from .parallel.partitioning import (clamp_specs_to_shapes, coherent_specs,
                                        decode_partition_specs, shard_params)

    specs = clamp_specs_to_shapes(mesh, tree, decode_partition_specs(tree))
    specs, blocks = coherent_specs(specs, replicate=replicate)
    local = shard_params(mesh, tree, specs, coords)
    if quantized:  # each block's leaves are all sliced or all whole: fusing is per rank
        local["llm"] = fuse_decode_projections(local["llm"])
        local = arrange_for_card(local)
    return local, blocks


class Transcriber:
    """The serving API. `params` may sit on the host or on `device`; every
    leaf is placed on `device` (`placer`). With `quantize` ("int8" or
    "int4") the decode tree is built one layer at a time from where the
    leaves are (`ops/quant.py::quantize_for_card`), so the float LLM is
    never on the card whole; an MoE tree refuses a quantize mode. A tree
    already in the card layout (`bridge.init_serving_params`) is served
    as it is, without `quantize`."""

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
        attn_route: Optional[str] = None,  # decode attention: None (auto), "kernel", "xla"
        select_mode: str = "fused",  # beam candidate selection: "fused" or "grid"
        no_repeat_ngram_size: int = 0,  # > 0: ban repeated n-grams (on the grid)
        mesh=None,  # a tp DeviceMesh: tensor-parallel serving, one rank per device
    ):
        self.model = model
        self.select_kernel = select_kernel
        self.attn_route = attn_route
        self.select_mode = select_mode
        self.no_repeat_ngram_size = no_repeat_ngram_size
        self.conv_kernel = conv_kernel
        self.video_pad_multiple = video_pad_multiple
        self.device = torch.device(device)
        place = placer(model.dtype, self.device, model.trainable_predicate())
        self.mesh, self.attn_mesh, self.par = mesh, None, None
        if mesh is not None:
            self.params = self._shard(params, quantize, place, mesh)
        elif quantize:  # built layer by layer from where the caller's leaves are
            from .ops.quant import quantize_for_card

            self.params = quantize_for_card(params, quantize, place)
        else:
            from .ops.quant import place_tree

            self.params = place_tree(params, place)
        self.num_beams = num_beams if num_beams is not None else model.cfg.num_beams
        self.max_new = max_new_tokens if max_new_tokens is not None else model.cfg.max_dec_tokens
        self.last_decode_steps = 0  # decode steps of the last batch
        self.last_file_seconds: Dict[str, float] = {}  # stages of the last transcribe_file

    def _shard(self, params: Params, quantize: Optional[str], place, mesh) -> Params:
        """This rank's shard of the serving tree (`omni_avsr_tpu/serve.py:
        63-101`): the whole tree placed and, with `quantize`, int8 without
        fused projections (the tp rules shard q, k, v and gate, up apart);
        cut by `decode_partition_specs`, clamped to the shapes and made
        coherent per block (`parallel/partitioning.py`); then q|k|v and
        gate|up fused and every int8 leaf laid out for the card, per rank.
        B1 runs per shard where the heads divide tp, else the decode takes
        the reorder route (the JAX package's `decode_attn_route = "xla"`)."""
        from .ops.beam_attention import beam_attn_shardable
        from .ops.quant import place_tree, quantize_llm_params, quantize_tower_params
        from .parallel.collectives import Parallel

        assert quantize in (None, "int8"), "int4 packed runtime is single-chip"
        llm_cfg = self.model.cfg.llm
        heads_divide = beam_attn_shardable(llm_cfg.num_heads, llm_cfg.num_kv_heads, mesh)
        if heads_divide:
            self.attn_mesh = mesh
        else:
            self.attn_route = "xla"
        tree = place_tree(params, place)
        if quantize:
            tree = dict(tree)
            tree["llm"] = quantize_llm_params(tree["llm"], 8)
            for tower in ("whisper", "avhubert"):
                if tower in tree:
                    tree[tower] = quantize_tower_params(tree[tower])
        local, blocks = shard_serving_tree(tree, mesh, bool(quantize),
                                           replicate=() if heads_divide else ("llm.attn",))
        del tree
        self.par = Parallel.of(mesh, blocks)
        return local

    @classmethod
    def from_pretrained(
        cls,
        checkpoint_path: str,
        llm_model: str = "meta-llama/Llama-3.2-1B",
        tokenizer: Optional[TokenizerBundle] = None,
        cfg: Optional[OmniConfig] = None,
        base_params: Optional[Params] = None,
        allow_random_base: bool = False,
        **kwargs,
    ) -> "Transcriber":
        """A trained reference `.pth` (converted by `convert/omni_ckpt.py`),
        or a directory (or `step_*.pt` file) of the port's own checkpoints,
        with a tokenizer (`load_hf_tokenizer(llm_model)` when none is
        given) and the config `registry_model(llm_model)` builds when none
        is given (`omni_avsr_tpu/serve.py:109-161`). The port's checkpoints
        hold only the trainable tree, which is merged over `base_params`
        (the converted frozen weights), or over random ones from seed 0
        (`bridge.init_params`) with `allow_random_base=True`, for tests.
        `kwargs` go to the constructor (device, quantize, num_beams...).
        Converted weights stay on the host until the constructor places
        them: with `quantize`, one layer at a time into the card tree."""
        from .data.tokenizer import load_hf_tokenizer
        from .models.omni import registry_model

        tok = tokenizer if tokenizer is not None else load_hf_tokenizer(llm_model)
        model = OmniAVSR(cfg, tok) if cfg is not None else registry_model(llm_model, tok)
        if os.path.isdir(checkpoint_path) or os.path.basename(checkpoint_path).startswith("step_"):
            from .train.checkpoint import resolve_checkpoint, restore_trainable
            from .train.state import merge_params

            device = kwargs.get("device", "cuda")
            if base_params is None:
                if not allow_random_base:
                    raise ValueError(
                        "the port's checkpoints hold only the trainable tree (LoRA and "
                        "projectors): pass the frozen Whisper, AV-HuBERT and LLM weights as "
                        "base_params (converted with omni_avsr_tpu_torch.convert), or "
                        "allow_random_base=True for random ones in tests")
                from .bridge import init_params

                base_params = init_params(model.cfg, torch.Generator(device=device).manual_seed(0),
                                          device)
            trained = restore_trainable(resolve_checkpoint(checkpoint_path), device)
            params = merge_params(trained, base_params)
        else:
            from .convert.omni_ckpt import convert_omni_checkpoint, load_torch_checkpoint

            params = convert_omni_checkpoint(load_torch_checkpoint(checkpoint_path), model.cfg)
        return cls(model, params, **kwargs)

    def decode_ids(self, batch: Dict[str, np.ndarray], modality: str, rate_audio: int,
                   rate_video: int, trim: int, num_beams: int) -> torch.Tensor:
        """Padded numpy batch -> (B, max_new) ids: the best beam hypothesis,
        or the greedy ids when `num_beams <= 1`."""
        from .parallel.collectives import scope

        with scope(self.par):
            out = decode_padded(self.model, self.params, batch, modality, rate_audio,
                                rate_video, trim, num_beams, self.max_new, self.device,
                                select_kernel=self.select_kernel, conv_kernel=self.conv_kernel,
                                attn_route=self.attn_route, select_mode=self.select_mode,
                                no_repeat_ngram_size=self.no_repeat_ngram_size,
                                attn_mesh=self.attn_mesh)
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

    def transcribe_file(
        self,
        path: str,
        preprocessed: bool = False,
        detector: str = "auto",
        mean_face_path: Optional[str] = None,
        **kwargs,
    ) -> str:
        """A clip (`.npy` frames, or mp4 where OpenCV is installed) and its
        sibling `.wav` -> transcript (`omni_avsr_tpu/serve.py:283-318`). With
        preprocessed=False the mouth-ROI chain runs first, on this
        Transcriber's device (the reference single-clip demo flow):
        `detector` is a `build_detector` name; pass mean_face_path to warp
        onto the reference `20words_mean_face.npy`.
        `kwargs` go to `transcribe`. `last_file_seconds` holds the wall
        time of the detector, the ROI chain and the decode."""
        from .data.dataset import load_audio, load_video

        frames = load_video(path)
        try:
            audio = load_audio(path)
        except Exception:  # no sibling wav: the clip has video only
            audio = None
        times = {}
        if not preprocessed:
            from .preprocess.detector import build_detector
            from .preprocess.mean_face import load_mean_face
            from .preprocess.video_process import extract_mouth_rois

            t = time.perf_counter()
            landmarks = build_detector(detector, device=self.device)(frames)
            times["detector_s"] = time.perf_counter() - t
            t = time.perf_counter()
            frames = extract_mouth_rois(frames, landmarks, load_mean_face(mean_face_path),
                                        device=self.device)
            times["roi_s"] = time.perf_counter() - t
            if frames is None:
                raise ValueError(f"{path}: no usable landmarks or clip shorter than the "
                                 f"12-frame smoothing window")
            # reference ROIs are grayscale; the model pipeline takes 3-channel
            frames = np.repeat(frames[..., None], 3, axis=-1)
        if audio is not None:
            audio = audio[: len(frames) * 640]
        t = time.perf_counter()
        text = self.transcribe(audio=audio, video=frames, **kwargs)
        times["decode_s"] = time.perf_counter() - t
        self.last_file_seconds = times
        return text
