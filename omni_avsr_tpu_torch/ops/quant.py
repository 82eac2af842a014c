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
Stacked (L, in, out) weights quantise and pack per layer. Codes, nibble
bytes and scales are bit-identical to the JAX package's. For the card,
`align_int8_columns` pads an int8 leaf's codes to a width that is a
multiple of 16 (zero columns); the true width is s.shape[-1].

`quantized_matmul` (B2, `_qmm_kernel`) and `quantized_matmul4` (B6,
`_qmm4_kernel`) compute y = (x @ w) * s[col] with an f32 accumulator. A
tensor on the CPU takes the plain version beside each; a CUDA tensor
launches the hand-written kernel in `csrc/quant_matmul.cu` or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

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


def align_int8_columns(tree: Dict) -> Dict:
    """Every int8 leaf whose width N is not a multiple of 16 gets zero
    code columns up to one: B2 loads each row of codes in 16-byte chunks.
    The true width stays s.shape[-1] (the Llama-3 lm_head has N = 128261);
    the padded columns are never computed."""

    def walk(node):
        if not isinstance(node, dict):
            return node
        w = node.get("w")
        if isinstance(w, torch.Tensor) and w.dtype == torch.int8 and "s" in node \
                and w.shape[-1] % 16:
            pad = -w.shape[-1] % 16
            return {**node, "w": torch.nn.functional.pad(w, (0, pad))}
        return {k: walk(v) for k, v in node.items()}

    return walk(tree)


def quantized_matmul_plain(x: torch.Tensor, q: Leaf,
                           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(M, K) x int8 (K, N) -> (M, N): the codes and x are exact in f32,
    so one f32 product accumulates the kernel's products; the scale
    applies to the f32 result. N = s.shape[-1] (`align_int8_columns`)."""
    w = q["w"][..., : q["s"].shape[-1]]
    y = torch.matmul(x.float(), w.float()) * q["s"].float()
    return y.to(out_dtype or x.dtype)


def quantized_matmul4_plain(x: torch.Tensor, q4: Leaf,
                            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The packed-int4 product through the unpacked int8 codes."""
    n = q4["s"].shape[-1]
    return quantized_matmul_plain(x, {"w": unpack_int4(q4["w4"], n), "s": q4["s"]}, out_dtype)


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=2)
def _launcher(int4: bool):
    """The C entry point for int8 or packed-int4 weights, built and typed
    once per process."""
    lib = load("quant_matmul")
    fn = lib.qmm4_launch if int4 else lib.qmm8_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _split_plan(M: int, ncols: int, K: int, device: torch.device) -> int:
    """Slices of K per output tile: enough blocks for about two per SM
    when the tiles alone are fewer than the SMs, each slice at least 4
    k-steps deep. The tiles (BM, BN, BK) are those of
    `csrc/quant_matmul.cu`: (64, 64, 64) for M <= 64, else (128, 128, 32)."""
    bm, bn, bk = (64, 64, 64) if M <= 64 else (128, 128, 32)
    tiles = -(-M // bm) * -(-ncols // bn)
    ktiles = -(-K // bk)
    sms = sm_count(device)
    if tiles >= sms:
        return 1
    splits = max(1, min(-(-2 * sms // tiles), ktiles // 4, 16))
    per = -(-ktiles // splits)
    return -(-ktiles // per)


def _launch(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor, n: int, bn2: int,
            out_dtype: Optional[torch.dtype], int4: bool) -> torch.Tensor:
    M, K = x.shape
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {out_dtype}: the kernel stores bf16 or f32")
    if K % 16:
        raise ValueError(f"K {K}: the kernel takes multiples of 16")
    check("x", x, (M, K), torch.bfloat16)
    check("s", s, (n,), torch.float32)
    if int4:
        if bn2 % 64:
            raise ValueError(f"block_n/2 {bn2}: the kernel takes multiples of 64")
        check("w4", w, (K, -(-n // (2 * bn2)), bn2), torch.int8)
    else:
        if w.shape[-1] < n or w.shape[-1] % 16:
            raise ValueError(f"w width {w.shape[-1]}: needs a multiple of 16 >= N {n} "
                             "(align_int8_columns)")
        check("w", w, (K, w.shape[-1]), torch.int8)
    if len({x.device, w.device, s.device}) != 1:
        raise ValueError("inputs on several devices")
    out = torch.empty((M, n), dtype=out_dtype, device=x.device)
    if M == 0:
        return out
    splits = _split_plan(M, w.shape[1] * 2 * bn2 if int4 else n, K, x.device)
    ws = torch.empty((splits * M * n if splits > 1 else 1,), dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        rc = _launcher(int4)(
            x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), ws.data_ptr(),
            M, n, K, bn2 if int4 else w.shape[-1], splits, int(out_dtype == torch.float32),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error {rc}")
    return out


def quantized_matmul(x: torch.Tensor, q: Leaf,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = (x @ w_int8) * s[col], (M, K) x (K, N) -> (M, N) in `out_dtype`
    (x's dtype by default; f32 for the logits). CPU tensors take the plain
    version; CUDA tensors (x bf16, w int8, s f32, contiguous) launch B2 and
    count the launch in `quantized_matmul.launches`."""
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, q, out_dtype)
    out = _launch(x, q["w"], q["s"], q["s"].shape[-1], 0, out_dtype, int4=False)
    quantized_matmul.launches += 1
    return out


def quantized_matmul4(x: torch.Tensor, q4: Leaf,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The packed-int4 product (B6): as `quantized_matmul`, with the
    weights two codes per byte; launches counted in
    `quantized_matmul4.launches`."""
    if x.device.type == "cpu":
        return quantized_matmul4_plain(x, q4, out_dtype)
    w4 = q4["w4"]
    out = _launch(x, w4, q4["s"], q4["s"].shape[-1], w4.shape[-1], out_dtype, int4=True)
    quantized_matmul4.launches += 1
    return out


quantized_matmul.launches = 0
quantized_matmul4.launches = 0
