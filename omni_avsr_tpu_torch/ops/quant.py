"""Weight-only int8 and packed-int4 decode weights (port of
`omni_avsr_tpu/ops/quant.py`): the host-side quantisers and packers, the
card layouts, and the matmul kernels' wrappers.

Leaf formats:
  - int8 {"w": int8 (in, out), "s": f32 (out,)}: symmetric per output
    channel, scale = max(|w|) / qmax over the input axis, codes round half
    to even (qmax 127; 7 for the int4-RTN codes that `pack_int4` packs).
  - packed int4 {"w4": int8 (in, chunks, block_n/2), "s": f32 (out,)}: two
    codes per byte. Within each `block_n`-wide column chunk the first half
    of the columns sits in the low nibble as offset binary (code + 8) and
    the second half in the high nibble, signed. block_n = 2 * w4.shape[-1].
  - the card layouts {"wc": int8 (..., Np/64, Kp/64, 4096), "s"} and
    {"w4c": int8 (..., Np/64, Kp/64, 2048), "s"}: the same codes arranged
    by `arrange_for_card` in the order in which the kernel's threads load
    them as tensor-core fragments (N padded to a multiple of 128 and K to
    one of 64 with zero codes);
    `card_int8_codes` and `card_int4_codes` give the codes back.
Stacked (L, in, out) weights quantise and pack per layer. Codes, nibble
bytes and scales are bit-identical to the JAX package's; the JAX-layout
leaf is the port's public format, and the serving tree arranges its int8
and int4 leaves for the card once (`serve.py`).

`quantized_matmul` (B2, `_qmm_kernel`) and `quantized_matmul4` (B6,
`_qmm4_kernel`) compute y = (x @ w) * s[col] with an f32 accumulator. A
tensor on the CPU takes the plain version beside each, which reads either
layout; a CUDA tensor launches the hand-written kernel in
`csrc/quant_matmul.cu` (one design templated on the code width, card
layout only), or raises.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from ..kernels import check, load, sm_count

Leaf = Dict[str, torch.Tensor]


def quantize_per_channel(w: torch.Tensor, bits: int = 8) -> Leaf:
    """(..., in, out) float -> {"w": int8, "s": f32 (..., out)}; bits=4
    gives int4-RTN codes in [-7, 7] in the int8 container."""
    qmax = float(2 ** (bits - 1) - 1)
    wf = w.float()
    amax = wf.abs().amax(dim=-2)
    scale = torch.clamp(amax / qmax, min=1e-12)
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -qmax, qmax).to(torch.int8).contiguous()
    return {"w": q, "s": scale}


def pack_int4(q: Leaf, block_n: int = 512) -> Leaf:
    """{"w": int8 codes in [-8, 7] (..., K, N), "s"} -> {"w4": int8
    (..., K, chunks, block_n/2), "s"}: N padded with zero codes to a
    multiple of block_n; low nibble = first half of each chunk + 8, high
    nibble = second half, signed (`omni_avsr_tpu/ops/quant.py:119-153`)."""
    w, s = q["w"], q["s"]
    *lead, K, N = w.shape
    bn2 = block_n // 2
    Np = -(-N // block_n) * block_n
    wp = torch.nn.functional.pad(w.to(torch.int32), (0, Np - N))
    g = wp.reshape(*lead, K, Np // block_n, 2, bn2)
    lo = g[..., 0, :] + 8
    hi = (g[..., 1, :] & 0xF) << 4
    return {"w4": (lo | hi).to(torch.uint8).view(torch.int8), "s": s}


def unpack_int4(w4: torch.Tensor, n: int) -> torch.Tensor:
    """The int8 codes (..., K, n) of a packed (..., K, chunks, block_n/2)
    weight."""
    p = w4.to(torch.int32) & 0xFF
    lo = (p & 0xF) - 8
    hi = ((p >> 4) ^ 8) - 8  # sign-extend the 4-bit high field
    return torch.stack([lo, hi], dim=-2).reshape(*w4.shape[:-2], -1)[..., :n].to(torch.int8)


def quantize_llm_params(params: Dict, bits: int = 8) -> Dict:
    """Quantised codes for the LLM layers' attn/mlp matrices and an
    unembedding copy under "lm_head" (tied models); LoRA, norms and the
    embedding table stay as they are."""
    out = dict(params)
    layers = dict(params["layers"])
    for blk_name in ("attn", "mlp"):
        blk = dict(layers[blk_name])
        for k, leaf in blk.items():
            blk[k] = {**leaf, **quantize_per_channel(leaf["w"], bits)}
        layers[blk_name] = blk
    out["layers"] = layers
    if "lm_head" in params:
        out["lm_head"] = quantize_per_channel(params["lm_head"]["w"], bits)
    else:
        out["lm_head"] = quantize_per_channel(params["embed"]["w"].t(), bits)
    return out


def quantize_tower_params(params: Dict) -> Dict:
    """int8 for an encoder tower's stacked (L, in, out) matrices under
    "layers"; conv weights, norms, biases and LoRA adapters stay put."""

    def walk(node, in_layers: bool):
        if not isinstance(node, dict):
            return node
        w = node.get("w")
        if in_layers and isinstance(w, torch.Tensor) and w.ndim == 3 and w.dtype != torch.int8:
            return {**node, **quantize_per_channel(w)}
        return {k: (v if k == "lora" else walk(v, in_layers or k == "layers"))
                for k, v in node.items()}

    return walk(params, False)


def pack_llm_int4(llm: Dict, block_n: int = 512) -> Dict:
    """Every {"w": int8, "s"} leaf of a quantised (and fused) LLM tree ->
    the packed {"w4", "s"} format, other keys of the leaf kept."""

    def walk(node):
        if not isinstance(node, dict):
            return node
        w = node.get("w")
        if isinstance(w, torch.Tensor) and w.dtype == torch.int8 and "s" in node:
            rest = {k: v for k, v in node.items() if k not in ("w", "s")}
            return {**rest, **pack_int4({"w": w, "s": node["s"]}, block_n)}
        return {k: walk(v) for k, v in node.items()}

    return walk(llm)


def fuse_decode_projections(llm: Dict) -> Dict:
    """Concatenate q|k|v and gate|up along the output axis: the decode step
    streams 4 weight buffers per layer instead of 7, with the same values
    (output columns are computed independently)."""

    def cat(entries):
        keys = entries[0].keys()
        assert all(e.keys() == keys for e in entries), "mismatched leaves"
        return {k: torch.cat([e[k] for e in entries], dim=-1) for k in keys}

    out = dict(llm)
    layers = dict(llm["layers"])
    attn = dict(layers["attn"])
    attn["qkv"] = cat([attn.pop("q"), attn.pop("k"), attn.pop("v")])
    layers["attn"] = attn
    mlp = dict(layers["mlp"])
    mlp["gateup"] = cat([mlp.pop("gate"), mlp.pop("up")])
    layers["mlp"] = mlp
    out["layers"] = layers
    return out


def quantize_for_decode(merged: Dict, mode: str) -> Dict:
    """"int8": weight-only int8 on the LLM (q|k|v and gate|up fused) and on
    the Whisper and AV-HuBERT layer stacks. "int4": int4-RTN codes on the
    LLM, fused, then packed two per byte; the towers stay int8."""
    if not mode:
        return merged
    if mode not in ("int8", "int4"):
        raise ValueError(f"quantize mode {mode!r}: expected 'int8' or 'int4'")
    out = dict(merged)
    llm = fuse_decode_projections(quantize_llm_params(merged["llm"], 4 if mode == "int4" else 8))
    out["llm"] = pack_llm_int4(llm) if mode == "int4" else llm
    for tower in ("whisper", "avhubert"):
        if tower in merged:
            out[tower] = quantize_tower_params(merged[tower])
    return out


# ---------------------------------------------------------------------------
# B2 and B6: the matmul kernels' wrappers and plain versions
# ---------------------------------------------------------------------------


# the card layouts' tiles: 64 weight columns x 64 k per chunk of 4096
# (int8) or 2048 (int4) bytes; N padded to 128 so that a block of two
# 64-column warpgroups stays in range
CARD_PAD_N, CARD_PAD_K = 128, 64
# int8: (k-step, k half, k 16-step, k + 8, lane % 4, pair element, 64-column
# tile, 16-column tile, row + 8, lane / 4) -> (64-column tile, k-step,
# 16-column tile, k half, lane / 4, lane % 4, k 16-step, k + 8, row + 8,
# pair element): a lane's 16 bytes are its mma A fragments a0-a3 of two
# 16-deep steps, bf16 pairs in register order
_CARD_PERM = (6, 0, 7, 1, 9, 4, 2, 3, 8, 5)
_CARD_INV = tuple(sorted(range(10), key=_CARD_PERM.__getitem__))
# int4: (k-step, k 16-step, k + 8, lane % 4, pair element, 64-column tile,
# 16-column tile, row + 8, lane / 4) -> (64-column tile, k-step, 16-column
# tile, lane / 4, lane % 4, k 16-step, pair element, k + 8, row + 8): a
# lane's 16 bytes are one 32-bit word per 16-deep step, whose nibble
# 4 * element + j (j = 2 * (k + 8) + (row + 8)) is A register j's code
_CARD4_PERM = (5, 0, 6, 8, 3, 1, 4, 2, 7)
_CARD4_INV = tuple(sorted(range(9), key=_CARD4_PERM.__getitem__))


def _pad_codes(w: torch.Tensor, value: int = 0):
    *lead, K, N = w.shape
    kp, np_ = -(-K // CARD_PAD_K) * CARD_PAD_K, -(-N // CARD_PAD_N) * CARD_PAD_N
    return torch.nn.functional.pad(w, (0, np_ - N, 0, kp - K), value=value), lead, kp, np_


def card_int8_layout(w: torch.Tensor) -> torch.Tensor:
    """int8 codes (..., K, N) -> the card layout (..., Np/64, Kp/64, 4096)."""
    wp, lead, kp, np_ = _pad_codes(w)
    nl = len(lead)
    g = wp.reshape(*lead, kp // 64, 2, 2, 2, 4, 2, np_ // 64, 4, 2, 8)
    g = g.permute(*range(nl), *(nl + d for d in _CARD_PERM))
    return g.reshape(*lead, np_ // 64, kp // 64, 4096).contiguous()


def card_int8_codes(wc: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """The inverse of `card_int8_layout`: the JAX codes (..., k, n)."""
    *lead, n64, ks, _ = wc.shape
    nl = len(lead)
    g = wc.reshape(*lead, n64, ks, 4, 2, 8, 4, 2, 2, 2, 2)
    g = g.permute(*range(nl), *(nl + d for d in _CARD_INV))
    return g.reshape(*lead, ks * 64, n64 * 64)[..., :k, :n]


def card_int4_layout(w: torch.Tensor) -> torch.Tensor:
    """int4 codes in [-8, 7] (..., K, N), one per int8 -> the card layout
    (..., Np/64, Kp/64, 2048): two offset codes (code + 8) per byte, the
    lower nibble first; padding is code 0."""
    wp, lead, kp, np_ = _pad_codes(w.to(torch.int32) + 8, value=8)
    nl = len(lead)
    g = wp.reshape(*lead, kp // 64, 4, 2, 4, 2, np_ // 64, 4, 2, 8)
    g = g.permute(*range(nl), *(nl + d for d in _CARD4_PERM))
    g = g.reshape(*lead, np_ // 64, kp // 64, 2048, 2)
    return (g[..., 0] | (g[..., 1] << 4)).to(torch.uint8).view(torch.int8).contiguous()


def card_int4_codes(w4c: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """The inverse of `card_int4_layout`: the int4 codes (..., k, n) as int8."""
    *lead, n64, ks, _ = w4c.shape
    nl = len(lead)
    p = w4c.to(torch.int32) & 0xFF
    nib = torch.stack([p & 0xF, p >> 4], dim=-1)
    g = nib.reshape(*lead, n64, ks, 4, 8, 4, 4, 2, 2, 2)
    g = g.permute(*range(nl), *(nl + d for d in _CARD4_INV))
    return (g.reshape(*lead, ks * 64, n64 * 64)[..., :k, :n] - 8).to(torch.int8)


def arrange_for_card(tree: Dict) -> Dict:
    """Every int8 leaf {"w", "s"} of a tree -> {"wc", "s"} in the card
    layout that B2 reads, and every packed-int4 leaf {"w4", "s"} -> {"w4c",
    "s"} in the one that B6 reads, other keys kept; float weights stay as
    they are. Stacked (L, K, N) leaves keep their leading axis, so
    `models/common.py::layer_slice` still takes one layer."""

    def walk(node):
        if not isinstance(node, dict):
            return node
        w = node.get("w")
        if isinstance(w, torch.Tensor) and w.dtype == torch.int8 and "s" in node:
            return {**{k: v for k, v in node.items() if k != "w"}, "wc": card_int8_layout(w)}
        if "w4" in node and "s" in node:
            codes = unpack_int4(node["w4"], node["s"].shape[-1])
            return {**{k: v for k, v in node.items() if k != "w4"},
                    "w4c": card_int4_layout(codes)}
        return {k: walk(v) for k, v in node.items()}

    return walk(tree)


def int8_codes(q: Leaf, k: int) -> torch.Tensor:
    """The JAX-layout codes (K, N) of an int8 leaf in either layout; k is
    the input width, which the card layout pads."""
    if "wc" in q:
        return card_int8_codes(q["wc"], k, q["s"].shape[-1])
    return q["w"]


def int4_codes(q4: Leaf, k: int) -> torch.Tensor:
    """The int4 codes (K, N) as int8 of a packed-int4 leaf in either
    layout."""
    n = q4["s"].shape[-1]
    if "w4c" in q4:
        return card_int4_codes(q4["w4c"], k, n)
    return unpack_int4(q4["w4"], n)


def require_card_layout(q: Leaf, bits: int = 8) -> torch.Tensor:
    """The codes B2 (bits 8) or B6 (bits 4) reads, or a ValueError for a
    leaf in the JAX layout: the kernel never re-arranges weights per call."""
    key = "wc" if bits == 8 else "w4c"
    if key not in q:
        raise ValueError(f"int{bits} leaf in the JAX layout: the kernel reads the card layout "
                         f"(ops/quant.py::arrange_for_card, once, where the serving tree is "
                         f"laid out)")
    return q[key]


def quantized_matmul_plain(x: torch.Tensor, q: Leaf,
                           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(M, K) x int8 (K, N) -> (M, N): the codes and x are exact in f32,
    so one f32 product accumulates the kernel's products; the scale
    applies to the f32 result. Either int8 layout (`int8_codes`)."""
    w = int8_codes(q, x.shape[-1])
    y = torch.matmul(x.float(), w.float()) * q["s"].float()
    return y.to(out_dtype or x.dtype)


def quantized_matmul4_plain(x: torch.Tensor, q4: Leaf,
                            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The packed-int4 product through the int8 codes, from either int4
    layout (`int4_codes`)."""
    w = int4_codes(q4, x.shape[-1])
    return quantized_matmul_plain(x, {"w": w, "s": q4["s"]}, out_dtype)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=1)
def _launcher():
    """The C entry point of both widths, built and typed once per process."""
    fn = load("quant_matmul").qmm_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def qmm_plan(M: int, N: int, K: int, sms: int, bits: int = 8) -> Tuple[int, int, int, int, int]:
    """The launch plan (token tile, column warps, k split among a block's
    warps, ring stages, blocks) of B2 (bits 8) or B6 (bits 4) for an (M, K)
    x (K, N) product on a card with `sms` SMs; the C entry point refuses
    any other (`csrc/quant_matmul.cu`).

    M <= 64 (decode): one token tile, M rounded up to 16 (48 at M 45).
    Wide matrices (gate|up, the lm_head) take column groups of 128 (8
    column warps: half the x reads per weight byte of 64) with K split 2
    ways among a block's warps, and at most one block per SM, each walking
    its share of the groups (the lm_head's 1003). Narrow ones (q|k|v, o,
    down) take the narrowest groups, 16 or 32 columns, whose count still
    fits one round of blocks, so that every SM streams, with K split 8 or 4
    ways among the block's warps (several chains in flight per group); K
    that no split of 4 or 8 divides falls back to 64-column groups.

    M > 64 (towers, prefill): the wgmma kernel, 128 columns a block, token
    tiles of 256 or 128, whichever pads M less (on a tie 256, unless its
    tiles would fill less than half the SMs), one block a tile; where the
    256-token tiles would fill less than a quarter of the SMs (the towers'
    1024-wide products at the bucketed window), the mma.sync kernel in
    64-token tiles, 64 or 128 columns a group, K split 2 or 4 ways.

    As many ring stages as fit in shared memory beside the k split's
    partial sums, at most 8: an int4 step carries half the code bytes of an
    int8 one, so its ring can be deeper."""
    steps = -(-K // 64)
    if M <= 64:
        nt, blocks = -(-M // 16) * 16, sms
        if -(-N // 128) >= sms // 2:
            cw, ks = 8, 2 if steps % 2 == 0 else 1
        else:
            cw = next(c for c in (1, 2, 4) if -(-N // (16 * c)) <= sms or c == 4)
            ks = next((k for k in {1: (8, 4), 2: (4, 8), 4: (4, 2, 1)}[cw] if steps % k == 0),
                      None)
            if ks is None:
                cw, ks = 4, next(k for k in (4, 2, 1) if steps % k == 0)
    else:
        cols = -(-N // 128)
        nt = min((256, 128),
                 key=lambda t: (-(-M // t) * t, -t if 2 * cols * -(-M // t) >= sms else t))
        cw, ks = 8, 1
        blocks = cols * -(-M // nt)
        if cols * -(-M // 256) <= sms // 4:  # too few tiles to fill the card: mma.sync
            nt, cw = 64, 4 if -(-M // 64) <= 8 else 8
            ks = next(k for k in ((4, 2, 1) if cw == 4 and K >= 4096 else (2, 1))
                      if steps % k == 0)
            blocks = sms
    stage = ks * (nt * 128 + cw * 16 * bits * 8)
    room = 232448 - 1024 - 128 - (ks - 1) * cw * nt * 64
    return nt, cw, ks, max(2, min(8, room // stage)), blocks


def _launch(x: torch.Tensor, q: Leaf, out_dtype: Optional[torch.dtype],
            bits: int) -> torch.Tensor:
    wc, s = require_card_layout(q, bits), q["s"]
    M, K = x.shape
    n = s.shape[-1]
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {out_dtype}: the kernel stores bf16 or f32")
    if K % 16:
        raise ValueError(f"K {K}: the kernel takes multiples of 16")
    check("x", x, (M, K), torch.bfloat16)
    check("s", s, (n,), torch.float32)
    chunk = 512 * bits
    if wc.ndim != 3 or wc.shape[2] != chunk:
        raise ValueError(f"card layout shape {tuple(wc.shape)}: expected (Np/64, Kp/64, {chunk})")
    Np, Kp = wc.shape[0] * 64, wc.shape[1] * 64
    if not (0 <= Np - n < CARD_PAD_N and Np % CARD_PAD_N == 0 and 0 <= Kp - K < CARD_PAD_K):
        raise ValueError(f"card layout {tuple(wc.shape)} does not hold a ({K}, {n}) weight")
    check("codes", wc, tuple(wc.shape), torch.int8)
    if len({x.device, wc.device, s.device}) != 1:
        raise ValueError("inputs on several devices")
    out = torch.empty((M, n), dtype=out_dtype, device=x.device)
    if M == 0:
        return out
    plan = qmm_plan(M, n, K, sm_count(x.device), bits)
    with torch.cuda.device(x.device):
        rc = _launcher()(
            x.data_ptr(), wc.data_ptr(), s.data_ptr(), out.data_ptr(), M, n, K, Kp, Np, *plan,
            int(out_dtype == torch.float32), bits,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed (int{bits}): CUDA error {rc}")
    return out


def quantized_matmul(x: torch.Tensor, q: Leaf,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = (x @ w_int8) * s[col], (M, K) x (K, N) -> (M, N) in `out_dtype`
    (x's dtype by default; f32 for the logits). CPU tensors take the plain
    version (either layout); CUDA tensors (x bf16, the card layout of
    `arrange_for_card`, s f32, contiguous) launch B2 and count the
    launch in `quantized_matmul.launches` and, by (M, K, N), in
    `quantized_matmul.shapes`."""
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, q, out_dtype)
    out = _launch(x, q, out_dtype, 8)
    quantized_matmul.launches += 1
    quantized_matmul.shapes[(x.shape[0], x.shape[1], q["s"].shape[-1])] += 1
    return out


def quantized_matmul4(x: torch.Tensor, q4: Leaf,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The packed-int4 product (B6): as `quantized_matmul`, with the codes
    in the card layout of `arrange_for_card` on a CUDA tensor (either
    int4 layout on the CPU); launches counted in `quantized_matmul4.launches`
    and, by (M, K, N), in `quantized_matmul4.shapes`."""
    if x.device.type == "cpu":
        return quantized_matmul4_plain(x, q4, out_dtype)
    out = _launch(x, q4, out_dtype, 4)
    quantized_matmul4.launches += 1
    quantized_matmul4.shapes[(x.shape[0], x.shape[1], q4["s"].shape[-1])] += 1
    return out


quantized_matmul.launches = 0
quantized_matmul.shapes = collections.Counter()
quantized_matmul4.launches = 0
quantized_matmul4.shapes = collections.Counter()
