"""The work a served Omni-AVSR batch needs, counted term by term from the
configuration's shapes and the requests' own lengths (never from what a
kernel launched): model FLOPs, the int8 linears as (M, K, N) products, and
the bytes of keys and values the beam-decode attention reads.

Counting rules: valid lengths only (the padding a batch's window adds is
not counted): Whisper at 50 tokens a second of each clip (at least 25),
AV-HuBERT at each clip's frames, the decoder's prefill at each request's
valid prefix, every decode step over all B x K beam rows for the steps the
decode ran, each attending its valid prefix and the tokens generated so
far. A linear is one product of the model, whatever the program fuses.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from ..reference.omni import Vocabulary, whisper_tokens

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 (NVIDIA data sheet)
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3


def bound_s(M: int, K: int, N: int) -> float:
    """Least time of an int8 weight-only (M, K) x (K, N) product: int8
    weights and f32 scales read once, bf16 activations read once, bf16
    output written once, at the bandwidth; or its FLOPs at the bf16 peak."""
    if M <= 0:
        return 0.0
    nbytes = K * N + 4 * N + 2 * M * K + 2 * M * N
    return max(nbytes / PEAK_HBM_BYTES, 2.0 * M * K * N / PEAK_BF16_FLOPS)


def resnet_flops_per_frame(size: int = 88) -> float:
    """FLOPs of the ResNet3D frontend for one frame (the stem's 5-frame
    kernel counted per output frame): convs and the stem only."""

    def out(n, k, s, p):
        return (n + 2 * p - k) // s + 1

    n = out(size, 7, 2, 3)
    f = 2.0 * n * n * 64 * 5 * 7 * 7
    n = out(n, 3, 2, 1)  # max pool
    cin = 64
    for li, cout in enumerate((64, 128, 256, 512), start=1):
        s = 1 if li == 1 else 2
        m = out(n, 3, s, 1)
        f += 2.0 * m * m * cout * cin * 9 + 2.0 * m * m * cout * cout * 9  # block 0
        if li > 1:
            f += 2.0 * m * m * cout * cin  # downsample
        f += 2.0 * 2 * m * m * cout * cout * 9  # block 1
        n, cin = m, cout
    return f


class OmniWork:
    """Counts for one configuration."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        c = cfg
        self.h, self.ffn, self.L = c["hidden_size"], c["intermediate_size"], c["num_hidden_layers"]
        self.nh, self.nkv = c["num_attention_heads"], c["num_key_value_heads"]
        self.hd = self.h // self.nh
        self.V = c["vocab_size"]
        self.r = int(round(self.h / c["lora"]["rank_divisor"]))
        self.v_out = self.h // c["lora"]["v_out_divisor"]
        serving = c.get("serving", {})  # a served configuration's fixed rates
        self.ra, self.rv = serving.get("rate_audio"), serving.get("rate_video")
        self.prompt = {m: len(v) for m, v in Vocabulary(self.V, c["prompts"]).prompt.items()}

    # --- shapes ---------------------------------------------------------------

    def llm_mats(self) -> List[Tuple[int, int]]:
        h, hd = self.h, self.hd
        return [(h, self.nh * hd), (h, self.nkv * hd), (h, self.nkv * hd), (self.nh * hd, h),
                (h, self.ffn), (h, self.ffn), (self.ffn, h)]

    def lora_params(self) -> int:
        return 2 * self.h * self.r + self.r * self.h + self.r * self.v_out

    @staticmethod
    def tower_mats(D: int, F: int) -> List[Tuple[int, int]]:
        return [(D, D)] * 4 + [(D, F), (F, D)]

    def prefix_tokens(self, modality: str, frames: int) -> int:
        """Valid prefix tokens of one request."""
        n = self.prompt[modality]
        if modality in ("audio", "audiovisual"):
            n += 2 + whisper_tokens(frames * 640) // self.ra
        if modality in ("video", "audiovisual"):
            n += 2 + frames // self.rv
        return n

    # --- one decode call ------------------------------------------------------

    def call(self, modality: str, frames: Sequence[int], beams: int, steps: int) -> Dict:
        """{"flops", "int8": [(M, K, N) ...], "beam_attn_bytes"} of one
        `transcribe_many` call over clips of `frames` at `beams` beams that
        ran `steps` decode steps."""
        c = self.cfg
        B = len(frames)
        K = max(int(beams or 1), 1)
        R = B * K
        flops = 0.0
        int8: List[Tuple[int, int, int]] = []
        lin_llm = sum(k * n for k, n in self.llm_mats())
        if modality in ("audio", "audiovisual"):
            w = c["whisper"]
            D, F, Lw = w["hidden_size"], w["ffn_dim"], w["num_layers"]
            T = [whisper_tokens(f * 640) for f in frames]
            for t in T:
                flops += 2.0 * 2 * t * w["num_mel_bins"] * D * 3 + 2.0 * t * D * D * 3
                flops += Lw * (2.0 * t * (4 * D * D + 2 * D * F) + 4.0 * t * t * D)
            int8 += [(sum(T), k, n) for k, n in self.tower_mats(D, F)] * Lw
            I = c["projector"]["intermediate_size"]
            flops += sum(2.0 * (t // self.ra) * (D * I + I * self.h) for t in T)
        if modality in ("video", "audiovisual"):
            a = c["avhubert"]
            E, F, La = a["encoder_embed_dim"], a["encoder_ffn_dim"], a["encoder_layers"]
            ra = int(round(E / a["lora_rank_divisor"]))
            rn = resnet_flops_per_frame()
            for t in frames:
                flops += t * rn + 2.0 * t * 512 * E + 2.0 * t * 2 * E * E
                flops += 2.0 * t * E * (E // a["conv_pos_groups"]) * a["conv_pos"]
                flops += La * (2.0 * t * (4 * E * E + 2 * E * F + 4 * E * ra) + 4.0 * t * t * E)
            int8 += [(sum(frames), k, n) for k, n in self.tower_mats(E, F)] * La
            I = c["projector"]["intermediate_size"]
            flops += sum(2.0 * (t // self.rv) * (E * I + I * self.h) for t in frames)
        P = [self.prefix_tokens(modality, f) for f in frames]
        pair = 4.0 * self.nh * self.hd  # one query against one key: QK^T and PV, all heads
        for p in P:  # prefill: linears, LoRA, causal attention, then the head at the last token
            flops += 2.0 * p * (lin_llm + self.lora_params()) * self.L
            flops += self.L * pair * p * (p + 1) / 2
            flops += 2.0 * self.h * self.V
        int8 += [(sum(P), k, n) for k, n in self.llm_mats()] * self.L + [(B, self.h, self.V)]
        kv_row = self.nkv * self.hd * 2 * 2  # k and v of one position, bf16
        bytes_b1 = 0.0
        for t in range(steps):
            flops += 2.0 * R * ((lin_llm + self.lora_params()) * self.L + self.h * self.V)
            flops += self.L * pair * K * sum(p + t + 1 for p in P)
            int8 += [(R, k, n) for k, n in self.llm_mats()] * self.L + [(R, self.h, self.V)]
            per_layer = (sum(P) * kv_row + R * (t + 1) * kv_row
                         + 2 * R * self.nh * self.hd * 2)
            bytes_b1 += self.L * per_layer
        return {"flops": flops, "int8": int8, "beam_attn_bytes": bytes_b1}
