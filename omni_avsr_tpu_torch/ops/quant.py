"""Weight-only int8 and packed-int4 decode weights (port of
`omni_avsr_tpu/ops/quant.py`): the host-side quantisers and packers, and
the two matmul kernels' wrappers.

Leaf formats:
  - int8 {"w": int8 (in, out), "s": f32 (out,)}: symmetric per output
    channel, scale = max(|w|) / qmax over the input axis, codes round half
    to even (qmax 127; 7 for the int4-RTN codes that `pack_int4` packs).
  - packed int4 {"w4": int8 (in, chunks, block_n/2), "s": f32 (out,)}: two
    codes per byte. Within each `block_n`-wide column chunk the first half
    of the columns sits in the low nibble as offset binary (code + 8) and
    the second half in the high nibble, signed. block_n = 2 * w4.shape[-1].
  - int8 in the card layout {"wc": int8 (..., Np/64, Kp/64, 4096), "s"}:
    the same codes arranged by `arrange_int8_for_card` in the order in
    which B2's threads load them as tensor-core fragments (N padded to a
    multiple of 128 and K to one of 64 with zero codes); `card_int8_codes`
    gives the JAX codes back.
Stacked (L, in, out) weights quantise and pack per layer. Codes, nibble
bytes and scales are bit-identical to the JAX package's; the JAX-layout
leaf is the port's public format, and the serving tree arranges its int8
leaves for the card once (`serve.py`).

`quantized_matmul` (B2, `_qmm_kernel`) and `quantized_matmul4` (B6,
`_qmm4_kernel`) compute y = (x @ w) * s[col] with an f32 accumulator. A
tensor on the CPU takes the plain version beside each, which reads either
int8 layout; a CUDA tensor launches the hand-written kernel in
`csrc/quant_matmul.cu` (int8, card layout only) or `csrc/quant_matmul4.cu`
(packed int4), or raises.
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
    """The int8 codes (K, n) of a packed (K, chunks, block_n/2) weight."""
    p = w4.to(torch.int32) & 0xFF
    lo = (p & 0xF) - 8
    hi = ((p >> 4) ^ 8) - 8  # sign-extend the 4-bit high field
    K = w4.shape[0]
    return torch.stack([lo, hi], dim=-2).reshape(K, -1)[:, :n].to(torch.int8)


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


# the card layout's tiles: 64 weight columns x 64 k per 4096-byte chunk; N
# padded to 128 so that a block of two 64-column warpgroups stays in range
CARD_PAD_N, CARD_PAD_K = 128, 64
# (k-step, k half, k 16-step, k + 8, lane % 4, pair element, 64-column
# tile, 16-column tile, row + 8, lane / 4) -> (64-column tile, k-step,
# 16-column tile, k half, lane / 4, lane % 4, k 16-step, k + 8, row + 8,
# pair element): a lane's 16 bytes are its mma A fragments a0-a3 of two
# 16-deep steps, bf16 pairs in register order
_CARD_PERM = (6, 0, 7, 1, 9, 4, 2, 3, 8, 5)
_CARD_INV = tuple(sorted(range(10), key=_CARD_PERM.__getitem__))


def card_int8_layout(w: torch.Tensor) -> torch.Tensor:
    """int8 codes (..., K, N) -> the card layout (..., Np/64, Kp/64, 4096)."""
    *lead, K, N = w.shape
    kp, np_ = -(-K // CARD_PAD_K) * CARD_PAD_K, -(-N // CARD_PAD_N) * CARD_PAD_N
    wp = torch.nn.functional.pad(w, (0, np_ - N, 0, kp - K))
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


def arrange_int8_for_card(tree: Dict) -> Dict:
    """Every int8 leaf {"w", "s"} of a tree -> {"wc", "s"} in the card
    layout that B2 reads, other keys kept; packed-int4 leaves and float
    weights stay as they are. Stacked (L, K, N) leaves keep their leading
    axis, so `models/common.py::layer_slice` still takes one layer."""

    def walk(node):
        if not isinstance(node, dict):
            return node
        w = node.get("w")
        if isinstance(w, torch.Tensor) and w.dtype == torch.int8 and "s" in node:
            rest = {k: v for k, v in node.items() if k != "w"}
            return {**rest, "wc": card_int8_layout(w)}
        return {k: walk(v) for k, v in node.items()}

    return walk(tree)


def int8_codes(q: Leaf, k: int) -> torch.Tensor:
    """The JAX-layout codes (K, N) of an int8 leaf in either layout; k is
    the input width, which the card layout pads."""
    if "wc" in q:
        return card_int8_codes(q["wc"], k, q["s"].shape[-1])
    return q["w"]


def require_card_layout(q: Leaf) -> torch.Tensor:
    """The codes B2 reads, or a ValueError for a leaf in the JAX layout: the
    kernel never re-arranges weights per call."""
    if "wc" not in q:
        raise ValueError("int8 leaf in the JAX (K, N) layout: B2 reads the card layout "
                         "(ops/quant.py::arrange_int8_for_card, once, where the serving "
                         "tree is laid out)")
    return q["wc"]


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
    """The packed-int4 product through the unpacked int8 codes."""
    n = q4["s"].shape[-1]
    return quantized_matmul_plain(x, {"w": unpack_int4(q4["w4"], n), "s": q4["s"]}, out_dtype)


_ARGTYPES4 = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_ARGTYPES8 = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=2)
def _launcher(int4: bool):
    """The C entry point for int8 (card layout) or packed-int4 weights,
    built and typed once per process."""
    if int4:
        fn = load("quant_matmul4").qmm4_launch
        fn.argtypes = _ARGTYPES4
    else:
        fn = load("quant_matmul").qmm8_launch
        fn.argtypes = _ARGTYPES8
    fn.restype = ctypes.c_int
    return fn


def qmm8_plan(M: int, N: int, K: int, sms: int) -> Tuple[int, int, int, int, int]:
    """B2's launch plan (token tile, column warps, k split among a block's
    warps, ring stages, blocks) for an (M, K) x (K, N) product on a card
    with `sms` SMs; the C entry point refuses any other
    (`csrc/quant_matmul.cu`).

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
    partial sums, at most 8."""
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
    stage = ks * (nt * 128 + cw * 1024)
    room = 232448 - 1024 - 128 - (ks - 1) * cw * nt * 64
    return nt, cw, ks, max(2, min(8, room // stage)), blocks


def _split_plan(M: int, ncols: int, K: int, device: torch.device) -> int:
    """B6: slices of K per output tile, enough blocks for about two per SM
    when the tiles alone are fewer than the SMs, each slice at least 4
    k-steps deep. The tiles (BM, BN, BK) are those of
    `csrc/quant_matmul4.cu`: (64, 64, 64) for M <= 64, else (128, 128, 32)."""
    bm, bn, bk = (64, 64, 64) if M <= 64 else (128, 128, 32)
    tiles = -(-M // bm) * -(-ncols // bn)
    ktiles = -(-K // bk)
    sms = sm_count(device)
    if tiles >= sms:
        return 1
    splits = max(1, min(-(-2 * sms // tiles), ktiles // 4, 16))
    per = -(-ktiles // splits)
    return -(-ktiles // per)


def _out_dtype(x: torch.Tensor, out_dtype: Optional[torch.dtype]) -> torch.dtype:
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {out_dtype}: the kernel stores bf16 or f32")
    if x.shape[-1] % 16:
        raise ValueError(f"K {x.shape[-1]}: the kernel takes multiples of 16")
    return out_dtype


def _launch8(x: torch.Tensor, q: Leaf, out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    wc, s = require_card_layout(q), q["s"]
    M, K = x.shape
    n = s.shape[-1]
    out_dtype = _out_dtype(x, out_dtype)
    check("x", x, (M, K), torch.bfloat16)
    check("s", s, (n,), torch.float32)
    if wc.ndim != 3 or wc.shape[2] != 4096:
        raise ValueError(f"wc shape {tuple(wc.shape)}: expected (Np/64, Kp/64, 4096)")
    Np, Kp = wc.shape[0] * 64, wc.shape[1] * 64
    if not (0 <= Np - n < CARD_PAD_N and Np % CARD_PAD_N == 0 and 0 <= Kp - K < CARD_PAD_K):
        raise ValueError(f"wc {tuple(wc.shape)} does not hold a ({K}, {n}) weight")
    check("wc", wc, tuple(wc.shape), torch.int8)
    if len({x.device, wc.device, s.device}) != 1:
        raise ValueError("inputs on several devices")
    out = torch.empty((M, n), dtype=out_dtype, device=x.device)
    if M == 0:
        return out
    plan = qmm8_plan(M, n, K, sm_count(x.device))
    with torch.cuda.device(x.device):
        rc = _launcher(False)(
            x.data_ptr(), wc.data_ptr(), s.data_ptr(), out.data_ptr(), M, n, K, Kp, Np, *plan,
            int(out_dtype == torch.float32),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error {rc}")
    return out


def _launch4(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor, n: int, bn2: int,
             out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    M, K = x.shape
    out_dtype = _out_dtype(x, out_dtype)
    check("x", x, (M, K), torch.bfloat16)
    check("s", s, (n,), torch.float32)
    if bn2 % 64:
        raise ValueError(f"block_n/2 {bn2}: the kernel takes multiples of 64")
    check("w4", w, (K, -(-n // (2 * bn2)), bn2), torch.int8)
    if len({x.device, w.device, s.device}) != 1:
        raise ValueError("inputs on several devices")
    out = torch.empty((M, n), dtype=out_dtype, device=x.device)
    if M == 0:
        return out
    splits = _split_plan(M, w.shape[1] * 2 * bn2, K, x.device)
    ws = torch.empty((splits * M * n if splits > 1 else 1,), dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        rc = _launcher(True)(
            x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), ws.data_ptr(),
            M, n, K, bn2, splits, int(out_dtype == torch.float32),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_matmul4 kernel launch failed: CUDA error {rc}")
    return out


def quantized_matmul(x: torch.Tensor, q: Leaf,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = (x @ w_int8) * s[col], (M, K) x (K, N) -> (M, N) in `out_dtype`
    (x's dtype by default; f32 for the logits). CPU tensors take the plain
    version (either layout); CUDA tensors (x bf16, the card layout of
    `arrange_int8_for_card`, s f32, contiguous) launch B2 and count the
    launch in `quantized_matmul.launches` and, by (M, K, N), in
    `quantized_matmul.shapes`."""
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, q, out_dtype)
    out = _launch8(x, q, out_dtype)
    quantized_matmul.launches += 1
    quantized_matmul.shapes[(x.shape[0], x.shape[1], q["s"].shape[-1])] += 1
    return out


def quantized_matmul4(x: torch.Tensor, q4: Leaf,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The packed-int4 product (B6): as `quantized_matmul`, with the
    weights two codes per byte; launches counted in
    `quantized_matmul4.launches`."""
    if x.device.type == "cpu":
        return quantized_matmul4_plain(x, q4, out_dtype)
    w4 = q4["w4"]
    out = _launch4(x, w4, q4["s"], q4["s"].shape[-1], w4.shape[-1], out_dtype)
    quantized_matmul4.launches += 1
    return out


quantized_matmul.launches = 0
quantized_matmul.shapes = collections.Counter()
quantized_matmul4.launches = 0
