"""Dynamic-batching HTTP transcription server over `serve.Transcriber` (port
of `omni_avsr_tpu/cli/serve_http.py`), standard library only.

Requests queue on arrival; a batcher thread groups compatible ones (same
modality, beams and padded-window class) up to `--max-batch` within
`--max-wait-ms` and decodes each group with one
`Transcriber.transcribe_many` call on the card. A group that fails is
retried member by member, so one bad request errors alone. Unlike the JAX
batcher, which ends a group at the first incompatible request and puts
that one back at the tail of the queue (so that interleaved traffic of two
kinds decodes one request at a time), this one holds incompatible
requests aside, in arrival order, and they lead the next groups.

API (JSON over POST /transcribe):
  {"audio": [f32 at 16 kHz ...]              # or "audio_b64": base64 LE f32
   "video_b64": base64 raw uint8, "video_shape": [T, 96, 96, 3],
   "modality": "audio" | "video" | "audiovisual" (optional),
   "num_beams": int (optional)}
-> {"text": "...", "batch_size": N}
GET /healthz -> {"ok": true, "requests": n, "batches": m}

    python -m omni_avsr_tpu_torch.cli.serve_http --synthetic --port 8811
    python -m omni_avsr_tpu_torch.cli.serve_http --ckpt model_avg_4.pth \\
        --quantize-decode int8
`--synthetic` serves the JAX CLI's tiny model with random weights from
seed 0; `--device cpu` serves from the CPU.
"""

from __future__ import annotations

import argparse
import base64
import collections
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np


class _Pending:
    __slots__ = ("item", "modality", "beams", "bucket", "event", "result", "error",
                 "batch_size")

    def __init__(self, item, modality, beams, bucket=None):
        self.item = item
        self.modality = modality
        self.beams = beams
        self.bucket = bucket
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.batch_size = 0


class BatchingServer:
    """The request queue and the batcher thread around a Transcriber."""

    def __init__(self, transcriber, max_batch: int = 8, max_wait_ms: float = 30.0):
        self.t = transcriber
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.q: "queue.Queue[_Pending]" = queue.Queue()
        self.n_requests = 0
        self.n_batches = 0
        self._count = threading.Lock()  # handler threads submit concurrently
        self._held: "collections.deque[_Pending]" = collections.deque()  # the batcher's own
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, item, modality, beams) -> _Pending:
        # the key holds the item's padded-window class: a batch's shared
        # window then equals each member's own, so a transcript never depends
        # on its co-batch (`serve.py::Transcriber.bucket_class`)
        p = _Pending(item, modality, beams, bucket=self.t.bucket_class(item, modality))
        with self._count:
            self.n_requests += 1
        self.q.put(p)
        return p

    def shutdown(self):
        self._stop.set()
        self._thread.join(timeout=5)

    def _take(self, timeout: float) -> Optional[_Pending]:
        """The oldest request held aside, else the next from the queue
        within `timeout` seconds; None when none comes."""
        if self._held:
            return self._held.popleft()
        if timeout <= 0:
            return None
        try:
            return self.q.get(timeout=timeout)
        except queue.Empty:
            return None

    def _run(self):
        while not self._stop.is_set():
            first = self._take(0.1)
            if first is None:
                continue
            key = (first.modality, first.beams, first.bucket)
            group, aside = [first], []
            deadline = time.monotonic() + self.max_wait
            while len(group) < self.max_batch:
                nxt = self._take(deadline - time.monotonic())
                if nxt is None:
                    break
                if (nxt.modality, nxt.beams, nxt.bucket) == key:
                    group.append(nxt)
                else:  # incompatible: it leads a later group
                    aside.append(nxt)
            self._held.extendleft(reversed(aside))
            self._decode(group)

    def _decode(self, group):
        try:
            texts = self.t.transcribe_many([p.item for p in group], modality=group[0].modality,
                                           num_beams=group[0].beams)
            self.n_batches += 1
            for p, text in zip(group, texts):
                p.result = text
                p.batch_size = len(group)
        except Exception as e:  # reaches the client as a 500; the thread lives on
            if len(group) > 1:
                # one poison request must not fail its co-batch: each member
                # again alone, so that only the offender gets the error
                for p in group:
                    self._decode([p])
                return
            group[0].error = f"{type(e).__name__}: {e}"
        for p in group:
            p.event.set()


NEEDS = {"audio": ("audio",), "video": ("video",), "audiovisual": ("audio", "video")}


def _make_handler(server: BatchingServer, timeout_s: float):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                return self._json(200, {"ok": True, "requests": server.n_requests,
                                        "batches": server.n_batches})
            return self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/transcribe":
                return self._json(404, {"error": "not found"})
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n))
                item = {}
                if "audio" in req:
                    item["audio"] = np.asarray(req["audio"], np.float32)
                elif "audio_b64" in req:
                    item["audio"] = np.frombuffer(base64.b64decode(req["audio_b64"]),
                                                  np.float32).copy()
                if "video_b64" in req:
                    item["video"] = np.frombuffer(base64.b64decode(req["video_b64"]),
                                                  np.uint8).reshape(req["video_shape"]).copy()
                if not item:
                    return self._json(400, {"error": "no audio/video"})
                modality = req.get("modality") or (
                    "audiovisual" if ("audio" in item and "video" in item)
                    else "audio" if "audio" in item else "video")
                # a modality/payload mismatch is a 400 here: in the batcher it
                # would fail the whole group
                need = NEEDS.get(modality)
                if need is None:
                    return self._json(400, {"error": f"unknown modality {modality!r}"})
                missing = [k for k in need if k not in item]
                if missing:
                    return self._json(400, {"error": f"modality {modality!r} requires "
                                                     f"{'+'.join(need)}; missing {missing}"})
                pending = server.submit(item, modality, req.get("num_beams"))
            except Exception as e:
                return self._json(400, {"error": f"{type(e).__name__}: {e}"})
            if not pending.event.wait(timeout=timeout_s):
                return self._json(504, {"error": "decode timeout"})
            if pending.error is not None:
                return self._json(500, {"error": pending.error})
            return self._json(200, {"text": pending.result, "batch_size": pending.batch_size})

    return Handler


def serve(transcriber, port: int = 8811, max_batch: int = 8, max_wait_ms: float = 30.0,
          timeout_s: float = 600.0, host: str = "127.0.0.1"):
    """(httpd, batcher); the caller runs `httpd.serve_forever()`. Port 0
    takes a free port (`httpd.server_address[1]`)."""
    batcher = BatchingServer(transcriber, max_batch, max_wait_ms)
    httpd = ThreadingHTTPServer((host, port), _make_handler(batcher, timeout_s))
    return httpd, batcher


def _tiny_model(device):
    """The JAX CLI's `--synthetic` model (`omni_avsr_tpu/cli/serve_http.py:
    176-210`) and its random weights from seed 0, made on `device`."""
    import torch

    from ..bridge import init_params
    from ..config import AVHubertConfig, LLMConfig, LoRAConfig, OmniConfig, WhisperEncoderConfig
    from ..data.tokenizer import synthetic_tokenizer
    from ..models.omni import OmniAVSR

    llm = LLMConfig(
        family="llama", vocab_size=254, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=16, rope_scaling_factor=32.0,
        lora=LoRAConfig(rank_divisor=8, alpha=4, task_specific=True, v_out_divisor=2))
    cfg = OmniConfig(
        llm_model="meta-llama/Llama-3.2-1B", llm=llm,
        whisper=WhisperEncoderConfig(hidden_size=32, num_layers=1, num_heads=2, ffn_dim=64),
        avhubert=AVHubertConfig(encoder_embed_dim=48, encoder_layers=1, encoder_heads=4,
                                encoder_ffn_dim=96, audio_feat_dim=26, lora_rank_divisor=16),
        downsample_ratio_audio=(4, 16), downsample_ratio_video=(2, 5),
        projector_intermediate_size=32)
    model = OmniAVSR(cfg, synthetic_tokenizer("llama", base_vocab=254 - 7))
    return model, init_params(cfg, torch.Generator(device=device).manual_seed(0), device)


def parse_args(argv=None):
    p = argparse.ArgumentParser("serve_http")
    p.add_argument("--port", type=int, default=8811)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=30.0)
    p.add_argument("--num-beams", type=int, default=None)
    p.add_argument("--quantize-decode", default=None, choices=[None, "int8", "int4"])
    p.add_argument("--ckpt", default=None,
                   help="a reference .pth, or a directory of the port's checkpoints")
    p.add_argument("--llm-model", default="meta-llama/Llama-3.2-1B")
    p.add_argument("--synthetic", action="store_true",
                   help="tiny random model (wiring smoke, no checkpoint)")
    p.add_argument("--device", default="cuda",
                   help="torch device; without a CUDA device the server stops unless given cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..serve import Transcriber
    from .common import apply_numerics, check_args, read_numerics

    device = check_args(args)
    numerics = read_numerics()
    if args.synthetic:
        model, params = _tiny_model(device)
        t = Transcriber(model, params, num_beams=args.num_beams or 2, max_new_tokens=4,
                        quantize=args.quantize_decode, device=device)
    else:
        t = Transcriber.from_pretrained(args.ckpt, llm_model=args.llm_model,
                                        num_beams=args.num_beams,
                                        quantize=args.quantize_decode, device=device)
    apply_numerics(t, numerics)
    httpd, _ = serve(t, port=args.port, host=args.host, max_batch=args.max_batch,
                     max_wait_ms=args.max_wait_ms)
    print(f"serving on http://{args.host}:{httpd.server_address[1]} "
          f"(max_batch={args.max_batch}, wait={args.max_wait_ms}ms)", flush=True)
    httpd.serve_forever()


if __name__ == "__main__":
    main()
