"""Plain float32 reference of Omni-AVSR serving: media in, log-probabilities
of served tokens out. Written from the model's definition (Whisper-medium,
ResNet3D + AV-HuBERT-Large, matryoshka average pooling, per-rate
projectors, a Qwen2.5 decoder with task-specific LoRA on q and v); it
imports only torch and numpy and reads nothing the program derived.

Weight-only quantisation is worked out here again: `Weights(bits=8)`
quantises each matrix the configuration serves quantised (symmetric per
output channel, round half to even) and computes with the dequantised
values in float32; `bits=4` is the next precision below; `bits=None`
keeps the drawn values. TF32 is off while the reference runs.

The decode is checked twice. Teacher-forced, `Reference.logprobs` runs
the decoder once over each request's valid prefix followed by its served
tokens and returns the log-probabilities before each served token and
after the last one. By search, `Reference.beam_search` runs a beam search
of its own over its own log-probabilities from the same prefix, by the
rules of Hugging Face's `BeamSearchScorer`, and returns the best
normalised score it finds.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE, N_FFT, HOP, N_MELS = 16000, 400, 160, 80
SPECIALS = ("<bos>", "<eos>", "<pad>", "<audio>", "</audio>", "<video>", "</video>")


# --- inputs: padding windows, token ids ---------------------------------


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def ladder(n: int, base: int) -> int:
    """The smallest class >= n of the ladder base, then ~1.5x steps
    rounded up to the base."""
    v = base
    while v < n:
        v = round_up(int(v * 1.5), base)
    return v


def whisper_tokens(samples: int) -> int:
    """Whisper tokens a clip's samples give: 50 a second, at least 25."""
    return max((samples * 50) // SAMPLE_RATE, 25)


@dataclass
class Window:
    """The padded window a batch is served at: video frames (0 without
    video), audio samples (0 without audio) and Whisper tokens."""

    frames: int
    samples: int
    trim: int


def batch_window(lengths_frames: Sequence[int], lengths_samples: Sequence[int], modality: str,
                 pad_multiple: int = 32) -> Window:
    """A batch's window: video padded to its ladder class of `pad_multiple`
    frames, audio to 640 samples a padded frame (its own ladder class of
    640 x `pad_multiple` samples without video); Whisper sees 2 x trim mel
    frames, trim = the padded audio's tokens rounded up to 25, at most 1500."""
    frames = ladder(max(lengths_frames), pad_multiple) if modality != "audio" else 0
    samples = 0
    trim = 0
    if modality != "video":
        samples = frames * 640 if frames else ladder(max(lengths_samples), 640 * pad_multiple)
        trim = min(round_up(max(int(samples / SAMPLE_RATE * 50), 25), 25), 1500)
    return Window(frames, samples, trim)


class Vocabulary:
    """The word-order tokenizer the served model is given: words take ids in
    order of first use (the three prompts, audio, video, audiovisual, in
    that order), the top seven ids are the specials."""

    def __init__(self, vocab_size: int, prompts: Dict[str, str]):
        base = vocab_size - len(SPECIALS)
        self.ids = {s: base + i for i, s in enumerate(SPECIALS)}
        words: Dict[str, int] = {}
        self.prompt = {}
        for m in ("audio", "video", "audiovisual"):
            out = []
            for w in prompts[m].strip().split():
                if w not in words:
                    words[w] = len(words) % base
                out.append(words[w])
            self.prompt[m] = out
        self.eos = self.ids["<eos>"]


# --- weights -------------------------------------------------------------


def quantize(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric per-output-channel weight-only quantisation of an (..., in,
    out) matrix to `bits`, round half to even, returned dequantised in
    float32."""
    wf = w.float()
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.clamp(wf.abs().amax(dim=-2) / qmax, min=1e-12)[..., None, :]
    return torch.clamp(torch.round(wf / scale), -qmax, qmax) * scale


class Weights:
    """Float32 views of the drawn tree: matrices the configuration serves
    quantised come back quantised at `bits` and dequantised."""

    def __init__(self, tree: Dict, bits=None):
        self.tree, self.bits = tree, bits

    def get(self, path: str) -> torch.Tensor:
        node = self.tree
        for k in path.split("."):
            node = node[k]
        return node

    def mat(self, path: str, quantised: bool) -> torch.Tensor:
        w = self.get(path)
        return quantize(w, self.bits) if (quantised and self.bits) else w.float()

    def f(self, path: str) -> torch.Tensor:
        return self.get(path).float()


# --- audio -----------------------------------------------------------------


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, np.float64)
    lin = 3.0 * f / 200.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) * 27.0 / np.log(6.4),
                    lin)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), 200.0 * m / 3.0)


def mel_filters() -> np.ndarray:
    """(201, 80) triangular Slaney-normalised mel filters over 0-8 kHz."""
    freqs = np.linspace(0.0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(8000.0), N_MELS + 2))
    fb = np.zeros((N_FFT // 2 + 1, N_MELS))
    for i in range(N_MELS):
        lo, c, hi = hz[i], hz[i + 1], hz[i + 2]
        rise = (freqs - lo) / (c - lo)
        fall = (hi - freqs) / (hi - c)
        fb[:, i] = np.maximum(0.0, np.minimum(rise, fall)) * 2.0 / (hi - lo)
    return fb


def standardise(audio: np.ndarray, samples: int, device) -> torch.Tensor:
    """The clip zero-padded to `samples`, standardised over its own samples
    (mean 0, variance 1, eps 1e-8), zero past them."""
    n = min(len(audio), samples)
    x = torch.zeros(samples, dtype=torch.float64, device=device)
    a = torch.as_tensor(audio[:n], dtype=torch.float64, device=device)
    a = (a - a.mean()) / torch.sqrt(a.var(unbiased=False) + 1e-8)
    x[:n] = a
    return x.float()


def log_mel(x: torch.Tensor, frames: int) -> torch.Tensor:
    """Whisper's log-mel of a waveform, `frames` frames: Hann window of 400,
    hop 160, reflect-padded centres, power spectrum, Slaney mel, log10
    floored at 1e-10 and at the clip's maximum - 8, then (x + 4) / 4."""
    chunk = frames * HOP
    x = F.pad(x.double(), (0, max(0, chunk - x.shape[0])))[:chunk]
    x = F.pad(x[None, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[0, 0]
    win = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64, device=x.device)
    spec = torch.stft(x, N_FFT, HOP, window=win, center=False, return_complex=True)
    power = spec.abs().square()[:, :frames]  # (201, frames)
    fb = torch.as_tensor(mel_filters(), device=x.device)
    mel = torch.log10(torch.clamp(fb.t() @ power, min=1e-10))
    mel = torch.maximum(mel, mel.max() - 8.0)
    return ((mel + 4.0) / 4.0).t().float()  # (frames, 80)


# --- building blocks -----------------------------------------------------


def layer_norm(x, w: Weights, path: str, eps: float = 1e-5):
    return F.layer_norm(x, x.shape[-1:], w.f(f"{path}.scale"), w.f(f"{path}.bias"), eps)


def attention(q, k, v, mask=None):
    """q (T, Hq, D), k/v (S, Hkv, D): softmax(q k^T / sqrt(D)) v per head,
    query head h reading kv head h // (Hq / Hkv); mask (T, S) True = keep."""
    G = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("thd,shd->hts", q, k) * q.shape[-1] ** -0.5
    if mask is not None:
        s = s.masked_fill(~mask[None], float("-inf"))
    return torch.einsum("hts,shd->thd", torch.softmax(s, dim=-1), v)


def lin(x, w: Weights, path: str, quantised: bool, bias: bool = True):
    y = x @ w.mat(f"{path}.w", quantised)
    if bias:
        try:
            y = y + w.f(f"{path}.b")
        except KeyError:
            pass
    return y


# --- towers ---------------------------------------------------------------


def whisper(w: Weights, cfg: dict, mel: torch.Tensor) -> torch.Tensor:
    """Whisper encoder: (frames, 80) -> (frames / 2, D)."""
    c = cfg["whisper"]
    x = mel.t()[None]
    x = F.gelu(F.conv1d(x, w.f("whisper.conv1.w").permute(2, 1, 0), w.f("whisper.conv1.b"),
                        padding=1))
    x = F.gelu(F.conv1d(x, w.f("whisper.conv2.w").permute(2, 1, 0), w.f("whisper.conv2.b"),
                        stride=2, padding=1))[0].t()
    T, D = x.shape
    H = c["num_heads"]
    x = x + w.f("whisper.pos_embed")[:T]
    for i in range(c["num_layers"]):
        lw = _LayerView(w, "whisper.layers", i)
        h = layer_norm(x, lw, "attn_norm")
        q, k, v = (lin(h, lw, f"attn.{n}", True).reshape(T, H, -1) for n in "qkv")
        x = x + lin(attention(q, k, v).reshape(T, D), lw, "attn.o", True)
        h = layer_norm(x, lw, "mlp_norm")
        x = x + lin(F.gelu(lin(h, lw, "fc1", True)), lw, "fc2", True)
    return layer_norm(x, w, "whisper.final_norm")


class _LayerView(Weights):
    """Layer i of a stacked (L, ...) subtree, quantised as its parent."""

    def __init__(self, parent: Weights, prefix: str, i: int):
        super().__init__(parent.tree, parent.bits)
        self.prefix, self.i = prefix, i
        self._cache: Dict[str, torch.Tensor] = {}

    def get(self, path: str) -> torch.Tensor:
        return super().get(f"{self.prefix}.{path}")[self.i]

    def mat(self, path: str, quantised: bool) -> torch.Tensor:
        key = f"{path}:{quantised}"
        if key not in self._cache:
            self._cache[key] = super().mat(path, quantised)
        return self._cache[key]


def _bn(x, w: Weights, path: str):
    """Inference BatchNorm over the channel axis 1."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = torch.rsqrt(w.f(f"{path}.var") + 1e-5)
    return ((x - w.f(f"{path}.mean").view(shape)) * (w.f(f"{path}.scale") * inv).view(shape)
            + w.f(f"{path}.bias").view(shape))


def _prelu(x, a):
    return torch.where(x >= 0, x, a.view((1, -1) + (1,) * (x.dim() - 2)) * x)


def _conv(x, w: Weights, path: str, stride: int, pad: int):
    return F.conv2d(x, w.f(f"{path}.w").permute(3, 2, 0, 1), stride=stride, padding=pad)


def resnet(w: Weights, video: torch.Tensor) -> torch.Tensor:
    """(T, 88, 88) normalised grey frames -> (T, 512): a Conv3d stem
    (5, 7, 7) stride (1, 2, 2), BatchNorm, PReLU, 3x3 max pool, then
    ResNet-18 basic blocks with PReLU, then the spatial mean."""
    p = "avhubert.video_frontend"
    x = F.conv3d(video[None, None], w.f(f"{p}.stem.conv.w").permute(4, 3, 0, 1, 2),
                 stride=(1, 2, 2), padding=(2, 3, 3))  # (1, 64, T, 44, 44)
    x = _prelu(_bn(x, w, f"{p}.stem.bn"), w.f(f"{p}.stem.prelu"))
    x = x[0].transpose(0, 1)  # (T, 64, 44, 44)
    x = F.max_pool2d(x, 3, 2, 1)
    for li in range(1, 5):
        for b in (0, 1):
            q = f"{p}.layer{li}.b{b}"
            stride = 2 if (li > 1 and b == 0) else 1
            res = x
            if li > 1 and b == 0:
                res = _bn(_conv(x, w, f"{q}.downsample.conv", stride, 0), w, f"{q}.downsample.bn")
            h = _prelu(_bn(_conv(x, w, f"{q}.conv1", stride, 1), w, f"{q}.bn1"), w.f(f"{q}.prelu1"))
            h = _bn(_conv(h, w, f"{q}.conv2", 1, 1), w, f"{q}.bn2")
            x = _prelu(h + res, w.f(f"{q}.prelu2"))
    return x.mean(dim=(2, 3))


def avhubert(w: Weights, cfg: dict, video: torch.Tensor) -> torch.Tensor:
    """AV-HuBERT on video alone: (T, 88, 88) -> (T, E). The absent audio
    stream is zeros ahead of the video features; LayerNorm, projection,
    the grouped convolutional position encoding, pre-LN layers with LoRA on
    q and v, the top LayerNorm."""
    c = cfg["avhubert"]
    v = lin(resnet(w, video), w, "avhubert.video_proj", False)
    x = torch.cat([torch.zeros_like(v), v], dim=-1)
    x = lin(layer_norm(x, w, "avhubert.fuse_norm"), w, "avhubert.post_extract_proj", False)
    T, E = x.shape
    k, g = c["conv_pos"], c["conv_pos_groups"]
    pc = F.conv1d(x.t()[None], w.f("avhubert.pos_conv.w").permute(2, 1, 0), w.f("avhubert.pos_conv.b"),
                  padding=k // 2, groups=g)[0].t()[:T]
    x = x + F.gelu(pc)
    H = c["encoder_heads"]
    s = c["lora_scaling"]
    for i in range(c["encoder_layers"]):
        lw = _LayerView(w, "avhubert.layers", i)
        h = layer_norm(x, lw, "attn_norm")
        q = lin(h, lw, "attn.q", True) + lin(lin(h, lw, "lora.down_q", False, False), lw,
                                            "lora.up_q", False, False) * s
        kk = lin(h, lw, "attn.k", True)
        v = lin(h, lw, "attn.v", True) + lin(lin(h, lw, "lora.down_v", False, False), lw,
                                            "lora.up_v", False, False) * s
        o = attention(q.reshape(T, H, -1), kk.reshape(T, H, -1), v.reshape(T, H, -1))
        x = x + lin(o.reshape(T, E), lw, "attn.o", True)
        h = layer_norm(x, lw, "final_norm")
        x = x + lin(F.gelu(lin(h, lw, "fc1", True)), lw, "fc2", True)
    return layer_norm(x, w, "avhubert.top_norm")


def pool(x: torch.Tensor, rate: int) -> torch.Tensor:
    """Mean over non-overlapping windows of `rate` steps, remainder dropped."""
    n = x.shape[0] // rate
    return x[: n * rate].reshape(n, rate, -1).mean(dim=1)


def project(w: Weights, which: str, x: torch.Tensor, rate: int) -> torch.Tensor:
    p = f"{which}.per_rate.r{rate}"
    return lin(torch.relu(lin(x, w, f"{p}.fc1", False)), w, f"{p}.fc2", False)


def grey_frames(video_u8: np.ndarray, frames: int, device) -> torch.Tensor:
    """(T, H, W, C) uint8 -> (frames, 88, 88): the centred 88 x 88 crop,
    luma grey (0.299, 0.587, 0.114), normalised by (0.421, 0.165); frames
    past the clip are black."""
    v = torch.zeros((frames,) + video_u8.shape[1:], dtype=torch.float32, device=device)
    v[: len(video_u8)] = torch.as_tensor(video_u8, device=device).float()
    v = v / 255.0
    H, W = v.shape[1:3]
    oh, ow = (H - 88) // 2, (W - 88) // 2
    v = v[:, oh:oh + 88, ow:ow + 88]
    if v.shape[-1] == 3:
        v = v @ torch.tensor([0.299, 0.587, 0.114], device=device)
    else:
        v = v[..., 0]
    return (v - 0.421) / 0.165


# --- the decoder ------------------------------------------------------------


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of (T, H, D) at integer positions, halves rotated."""
    D = x.shape[-1]
    inv = 1.0 / (theta ** (np.arange(0, D, 2, dtype=np.float64) / D))
    ang = pos.float()[:, None] * torch.as_tensor(inv.astype(np.float32), device=x.device)
    cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None]
    rot = torch.cat([-x[..., D // 2:], x[..., : D // 2]], -1)
    return x * cos + rot * sin


@dataclass
class Request:
    """One served request as the reference sees it: media, the window of
    its batch, its modality and the tokens served for it."""

    audio: Optional[np.ndarray]
    video: Optional[np.ndarray]
    modality: str
    window: Window
    served: List[int]


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matmuls and convolutions while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Reference:
    """The configuration's model over a drawn tree, in float32 with the
    weight precision `bits`."""

    def __init__(self, cfg: dict, tree: Dict, bits: Optional[int], device):
        self.cfg, self.device = cfg, device
        self.w = Weights(tree, bits)
        self.vocab = Vocabulary(cfg["vocab_size"], cfg["prompts"])
        s = cfg["serving"]
        self.rate_a, self.rate_v = s["rate_audio"], s["rate_video"]
        self._prefixes: Dict[int, torch.Tensor] = {}

    def prefix(self, r: Request) -> torch.Tensor:
        """(n, h) embeddings of the request's valid prefix: [<audio> audio
        tokens </audio>][<video> video tokens </video>][prompt]; worked out
        once for each request object."""
        if id(r) not in self._prefixes:
            self._prefixes[id(r)] = self._prefix(r)
        return self._prefixes[id(r)]

    def _prefix(self, r: Request) -> torch.Tensor:
        w, ids, dev = self.w, self.vocab.ids, self.device
        emb = lambda tid: w.f("llm.embed.w")[tid][None]  # noqa: E731
        parts = []
        if r.modality in ("audio", "audiovisual"):
            x = standardise(r.audio, r.window.samples, dev)
            enc = whisper(w, self.cfg, log_mel(x, 2 * r.window.trim))[: r.window.trim]
            a = project(w, "audio_proj", pool(enc, self.rate_a), self.rate_a)
            n_a = whisper_tokens(min(len(r.audio), r.window.samples)) // self.rate_a
            parts += [emb(ids["<audio>"]), a[:n_a], emb(ids["</audio>"])]
        if r.modality in ("video", "audiovisual"):
            v = avhubert(w, self.cfg, grey_frames(r.video, r.window.frames, dev))
            v = project(w, "video_proj", pool(v, self.rate_v), self.rate_v)
            n_v = len(r.video) // self.rate_v
            parts += [emb(ids["<video>"]), v[:n_v], emb(ids["</video>"])]
        parts.append(w.f("llm.embed.w")[torch.as_tensor(self.vocab.prompt[r.modality], device=dev)])
        return torch.cat(parts)

    def logprobs(self, requests: Sequence[Request]) -> List[torch.Tensor]:
        """For each request, (len(served) + 1, V) log-probabilities: row t
        is the distribution the decoder gives for served token t, the last
        row the one after the last served token."""
        with float32_exact(), torch.no_grad():
            seqs, starts = [], []
            for r in requests:
                p = self.prefix(r)
                tok = self.w.f("llm.embed.w")[torch.as_tensor(r.served, dtype=torch.long,
                                                              device=self.device)]
                seqs.append(torch.cat([p, tok]))
                starts.append(p.shape[0] - 1)
            hidden = self._decoder(seqs, [r.modality for r in requests])
            out = []
            head = self.head()
            for x, s in zip(hidden, starts):
                logits = x[s:] @ head
                out.append(torch.log_softmax(logits, dim=-1))
            return out

    def head(self) -> torch.Tensor:
        """(h, V) output projection: the untied lm_head, or the tied
        embeddings transposed, at the weight precision."""
        if "lm_head" in self.w.tree["llm"]:
            return self.w.mat("llm.lm_head.w", True)
        emb = self.w.get("llm.embed.w").t()
        return quantize(emb, self.w.bits) if self.w.bits else emb.float()

    def _qkv(self, lw, x, m: str, pos: torch.Tensor):
        """Rotated queries (T, H, D), keys and values (T, Hkv, D) of one
        layer over rows x (T, h) at positions pos, with modality m's LoRA."""
        c = self.cfg
        H, Hkv = c["num_attention_heads"], c["num_key_value_heads"]
        s = c["lora"]["alpha"] / c["lora"]["rank_divisor"]
        T = x.shape[0]
        h = rms_norm(x, lw.f("input_norm.scale"), c["rms_norm_eps"])
        lo = f"lora.{m}"
        q = lin(h, lw, "attn.q", True) + lin(lin(h, lw, f"{lo}.down_q", False, False), lw,
                                            f"{lo}.up_q", False, False) * s
        k = lin(h, lw, "attn.k", True)
        v = lin(h, lw, "attn.v", True) + lin(lin(h, lw, f"{lo}.down_v", False, False), lw,
                                            f"{lo}.up_v", False, False) * s
        theta = c["rope_theta"]
        return (rope(q.reshape(T, H, -1), pos, theta), rope(k.reshape(T, Hkv, -1), pos, theta),
                v.reshape(T, Hkv, -1))

    def _rest(self, lw, x, o):
        """The layer after attention: output projection, residual, MLP."""
        x = x + lin(o, lw, "attn.o", True, bias=False)
        h = rms_norm(x, lw.f("post_attn_norm.scale"), self.cfg["rms_norm_eps"])
        g, u = lin(h, lw, "mlp.gate", True, False), lin(h, lw, "mlp.up", True, False)
        return x + lin(F.silu(g) * u, lw, "mlp.down", True, False)

    def _decoder(self, seqs: List[torch.Tensor], modalities: List[str], kv=None
                 ) -> List[torch.Tensor]:
        """The decoder stack over each sequence (causal, positions 0..n-1),
        one layer at a time for all sequences; returns the final-normed
        hidden states. With a list `kv`, appends each layer's [(k, v) of
        each sequence]."""
        c = self.cfg
        xs = list(seqs)
        for i in range(c["num_hidden_layers"]):
            lw = _LayerView(self.w, "llm.layers", i)
            kept = []
            for j, (x, m) in enumerate(zip(xs, modalities)):
                T = x.shape[0]
                q, k, v = self._qkv(lw, x, m, torch.arange(T, device=self.device))
                causal = torch.ones(T, T, dtype=torch.bool, device=self.device).tril()
                xs[j] = self._rest(lw, x, attention(q, k, v, causal).reshape(T, -1))
                kept.append((k, v))
            if kv is not None:
                kv.append(kept)
            del lw
        fn = self.w.f("llm.final_norm.scale")
        return [rms_norm(x, fn, c["rms_norm_eps"]) for x in xs]

    def beam_search(self, requests: Sequence[Request], num_beams: int, max_new: int,
                    length_penalty: float = 1.0) -> List[float]:
        """For each request (one modality for all), the best normalised
        score of a beam search over the reference's own log-probabilities
        from the request's prefix. Rules (Hugging Face `BeamSearchScorer`):
        the first step expands one beam; each step ranks the K x V
        candidates by cumulative log-probability and takes the best 2K; an
        EOS among the first K of them finishes a hypothesis, scored by its
        sum over max(t, 1) ** length_penalty, t its tokens before the EOS;
        the best K others run on; the K best finished hypotheses are kept;
        after `max_new` steps the running beams are scored by their sums
        over max_new ** length_penalty; the best of all wins."""
        K, eos, m = num_beams, self.vocab.eos, requests[0].modality
        c = self.cfg
        Hkv = c["num_key_value_heads"]
        G = c["num_attention_heads"] // Hkv
        with float32_exact(), torch.no_grad():
            pres = [self.prefix(r) for r in requests]
            kv: List = []
            last = torch.stack([x[-1] for x in self._decoder(pres, [m] * len(pres), kv)])
            head = self.head()
            B, N, dev = len(pres), max(p.shape[0] for p in pres), self.device
            n = torch.as_tensor([p.shape[0] for p in pres], device=dev)
            pad_ok = torch.arange(N, device=dev)[None] < n[:, None]  # (B, N)

            def padded(t):  # (n_b, Hkv, D) each -> (B, N, Hkv, D)
                out = t[0].new_zeros((B, N) + t[0].shape[1:])
                for b, x in enumerate(t):
                    out[b, : x.shape[0]] = x
                return out

            pre = [(padded([k for k, _ in layer]), padded([v for _, v in layer])) for layer in kv]
            del kv
            gen = [None] * len(pre)  # each layer's generated (k, v): (B, K, t, Hkv, D)
            logp = torch.log_softmax(last @ head, dim=-1)[:, None].expand(B, K, -1)
            V = logp.shape[-1]
            cum = torch.full((B, K), float("-inf"), device=dev)
            cum[:, 0] = 0.0
            best = torch.full((B, K), float("-inf"), device=dev)  # finished hypotheses
            scale = (c["hidden_size"] // c["num_attention_heads"]) ** -0.5
            for t in range(max_new):
                top, idx = (cum[:, :, None] + logp).reshape(B, K * V).topk(2 * K, dim=-1)
                parent, tok = idx // V, idx % V
                fin = (tok == eos) & (torch.arange(2 * K, device=dev)[None] < K)
                done = torch.where(fin, top / float(max(t, 1)) ** length_penalty,
                                   torch.full_like(top, float("-inf")))
                best = torch.cat([best, done], dim=1).topk(K, dim=-1).values
                run = torch.where(tok == eos, torch.full_like(top, float("-inf")), top)
                cum, keep = run.topk(K, dim=-1)
                parent, tok = parent.gather(1, keep), tok.gather(1, keep)
                if t == max_new - 1:
                    break
                x = self.w.f("llm.embed.w")[tok.reshape(-1)]  # (B*K, h)
                pos = (n[:, None] + t).expand(B, K).reshape(-1)
                for i, (pk, pv) in enumerate(pre):
                    lw = _LayerView(self.w, "llm.layers", i)
                    q, k, v = self._qkv(lw, x, m, pos)
                    k, v = k.reshape(B, K, 1, Hkv, -1), v.reshape(B, K, 1, Hkv, -1)
                    if gen[i] is not None:
                        gk, gv = (g.gather(1, parent[:, :, None, None, None].expand_as(g))
                                  for g in gen[i])
                        k, v = torch.cat([gk, k], dim=2), torch.cat([gv, v], dim=2)
                    gen[i] = (k, v)
                    q = q.reshape(B, K, Hkv, G, -1)
                    s_pre = torch.einsum("bkhgd,bnhd->bkhgn", q, pk) * scale
                    s_pre = s_pre.masked_fill(~pad_ok[:, None, None, None], float("-inf"))
                    s_gen = torch.einsum("bkhgd,bkthd->bkhgt", q, k) * scale
                    p = torch.softmax(torch.cat([s_pre, s_gen], dim=-1), dim=-1)
                    o = (torch.einsum("bkhgn,bnhd->bkhgd", p[..., :N], pv)
                         + torch.einsum("bkhgt,bkthd->bkhgd", p[..., N:], v))
                    x = self._rest(lw, x, o.reshape(B * K, -1))
                    del lw
                x_n = rms_norm(x, self.w.f("llm.final_norm.scale"), c["rms_norm_eps"])
                logp = torch.log_softmax(x_n @ head, dim=-1).reshape(B, K, V)
            final = cum / float(max_new) ** length_penalty
            return torch.cat([best, final], dim=1).amax(dim=1).tolist()
