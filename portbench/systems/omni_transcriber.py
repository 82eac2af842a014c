"""The system under test for Omni-AVSR configurations: the port's serving
API, `omni_avsr_tpu_torch.serve.Transcriber`, built from the benchmark's
own weights.

The harness reads the served ids of each request (the transcripts are
their text) by wrapping the instance's `decode_ids` and
`transcribe_many`; nothing of the program is changed.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import torch

from .. import weights


def omni_config(cfg: dict):
    """The port's `OmniConfig` of a configuration file."""
    from omni_avsr_tpu_torch.config import (AVHubertConfig, LLMConfig, LoRAConfig, OmniConfig,
                                            WhisperEncoderConfig)

    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    lo, w, a, p = cfg["lora"], cfg["whisper"], cfg["avhubert"], cfg["projector"]
    s = cfg["serving"]
    llm = LLMConfig(
        family="qwen", vocab_size=cfg["vocab_size"], hidden_size=h,
        intermediate_size=cfg["intermediate_size"], num_layers=cfg["num_hidden_layers"],
        num_heads=nh, num_kv_heads=cfg["num_key_value_heads"], head_dim=h // nh,
        rms_norm_eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"], rope_scaling_factor=None,
        tie_word_embeddings=cfg["tie_word_embeddings"], attention_bias=True,
        lora=LoRAConfig(rank_divisor=lo["rank_divisor"], alpha=lo["alpha"], task_specific=True,
                        v_out_divisor=lo["v_out_divisor"]))
    whisper = WhisperEncoderConfig(
        num_mel_bins=w["num_mel_bins"], hidden_size=w["hidden_size"], num_layers=w["num_layers"],
        num_heads=w["num_heads"], ffn_dim=w["ffn_dim"],
        max_source_positions=w["max_source_positions"], layer_norm_eps=w["layer_norm_eps"])
    avhubert = AVHubertConfig(
        encoder_embed_dim=a["encoder_embed_dim"], encoder_layers=a["encoder_layers"],
        encoder_heads=a["encoder_heads"], encoder_ffn_dim=a["encoder_ffn_dim"],
        audio_feat_dim=a["audio_feat_dim"], conv_pos=a["conv_pos"],
        conv_pos_groups=a["conv_pos_groups"], lora_rank_divisor=a["lora_rank_divisor"],
        lora_scaling=a["lora_scaling"])
    return OmniConfig(
        llm_model=cfg["llm_model"], llm=llm, whisper=whisper, avhubert=avhubert,
        whisper_input_mode=s["whisper_input_mode"],
        downsample_ratio_audio=tuple(p["rates_audio"]),
        downsample_ratio_video=tuple(p["rates_video"]),
        projector_intermediate_size=p["intermediate_size"],
        prompt_audio=cfg["prompts"]["audio"], prompt_video=cfg["prompts"]["video"],
        prompt_audiovisual=cfg["prompts"]["audiovisual"],
        max_dec_tokens=s["max_new_tokens"], num_beams=s["num_beams"])


class System:
    """A Transcriber on the configuration's weights, drawn from `seed`, and
    the served ids of every request it decoded (`served`, by request id),
    with each decode call's wall span, requests, modality, beams and
    decode steps (`calls`)."""

    def __init__(self, cfg: dict, seed: int, device, quantize: Optional[str] = None,
                 dtype=torch.bfloat16):
        from omni_avsr_tpu_torch.data.tokenizer import synthetic_tokenizer
        from omni_avsr_tpu_torch.models.omni import OmniAVSR
        from omni_avsr_tpu_torch.serve import Transcriber

        s = cfg["serving"]
        self.cfg, self.device = cfg, torch.device(device)
        tok = synthetic_tokenizer("qwen", base_vocab=cfg["vocab_size"] - 7)
        self.model = OmniAVSR(omni_config(cfg), tok, dtype=dtype)
        tree = weights.draw(cfg, seed, self.device, dtype)
        mode = quantize if quantize is not None else s["quantize"]
        self.t = Transcriber(self.model, tree, quantize=mode or None, device=self.device,
                             video_pad_multiple=s["video_pad_multiple"])
        del tree
        self.served: Dict[int, torch.Tensor] = {}
        self.calls: List[dict] = []
        self._rid: Dict[int, int] = {}
        self._last = None
        decode_ids, transcribe_many = self.t.decode_ids, self.t.transcribe_many

        def record_ids(*a, **k):
            self._last = decode_ids(*a, **k)
            return self._last

        def record_many(items, **k):
            t0 = time.perf_counter()
            texts = transcribe_many(items, **k)
            t1 = time.perf_counter()
            ids = self._last.cpu()
            for it, row in zip(items, ids):
                rid = self._rid.get(id(it))
                if rid is not None:
                    self.served[rid] = row
            self.calls.append({"t0": t0, "t1": t1, "rids": [self._rid.get(id(it)) for it in items],
                               "modality": k.get("modality"), "beams": k.get("num_beams"),
                               "steps": self.t.last_decode_steps})
            return texts

        self.t.decode_ids = record_ids
        self.t.transcribe_many = record_many

    def tag(self, rid: int, item) -> None:
        """Names `item` as request `rid` for the served-id record."""
        self._rid[id(item)] = rid

    def serve(self, items, modality: str, beams: int):
        return self.t.transcribe_many(items, modality=modality, num_beams=beams)

    def window_calls(self, run: Dict) -> List[dict]:
        """The decode calls that served the window's requests."""
        reqs = {r.rid for r in run["requests"]}
        return [c for c in self.calls if any(i in reqs for i in c["rids"] if i is not None)]

    def units(self, run: Dict, work) -> List[Dict]:
        """The work of each of the window's decode calls (`work.call`)."""
        reqs = {r.rid: r for r in run["requests"]}
        return [work.call(c["modality"], [reqs[i].frames for i in c["rids"] if i is not None],
                          c["beams"], c["steps"]) for c in self.window_calls(run)]

    def spans(self, run: Dict):
        """The harness's host spans of the window, for the trace's idle gaps."""
        return [(f"serving API: transcribe_many of {len(c['rids'])} ({c['modality']}, "
                 f"beams {c['beams']})", c["t0"], c["t1"]) for c in self.window_calls(run)]

    def record(self, run: Dict) -> Dict:
        """What the check needs, off the device: the window's requests, the
        ids served for each, every decode call."""
        calls = self.window_calls(run)
        answered = sum(1 for r in run["requests"] if r.rid in self.served)
        return {"requests": run["requests"], "served": dict(self.served), "calls": list(self.calls),
                "failed": run["attempted"] - answered,
                "info": {"calls": len(calls), "call_s": [round(c["t1"] - c["t0"], 3)
                                                         for c in calls]}}

    def forget(self) -> None:
        """Drops the warm-up's records."""
        self.served.clear()
        self.calls.clear()

    def close(self) -> None:
        """Frees the serving tree (the recording wrappers make a cycle)."""
        self.t = None
        self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def check(cfg: dict, seed: int, device, record: Dict, cellcheck: dict, dtype=None) -> Dict:
    """The compared numbers of one run: `check.compare`'s gaps over the
    sample, and the window's requests that never got a result."""
    from .. import check as chk

    bits = {"int8": 8, "int4": 4}.get(cfg["serving"]["quantize"])
    numbers = chk.compare(cfg, seed, device, record["requests"], record["served"],
                          record["calls"], cellcheck["sample"], bits, dtype or torch.bfloat16)
    numbers["unanswered"] = float(record["failed"])
    return numbers
