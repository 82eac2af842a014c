"""Beam-decode attention on the ancestor cache: the port of the TPU kernel
`omni_avsr_tpu/ops/beam_attention.py::_kernel` (B1).

One decode step for every beam of every batch item, over all kv heads:
[shared prefix | per-beam generated | current token] logits in one joint
f32 softmax, then the value contraction. The generated cache stays
UNPERMUTED: entry (row r, slot n) is live for beam k iff anc[b, k, n] == r
and n < step, which is exactly the cache a physical reorder by parent beam
would have produced, without the per-step gather.

`beam_decode_attention` is the wrapper the decoder calls. A tensor on the
CPU takes `beam_decode_attention_plain`, the same masked joint softmax in
torch; a CUDA tensor launches the hand-written kernel in
`csrc/beam_attention.cu` (built with nvcc on first use) or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

NEG_INF = -1e30  # the TPU kernel's mask value for generated/current lanes

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]


def beam_decode_attention_plain(
    q: torch.Tensor,  # (B*K, 1, Hq, D)
    pk: torch.Tensor,  # (B, Hkv, P, D)
    pv: torch.Tensor,
    gk: torch.Tensor,  # (B, Hkv, K, N, D), unpermuted rows
    gv: torch.Tensor,
    k_cur: torch.Tensor,  # (B*K, Hkv, D)
    v_cur: torch.Tensor,
    prefix_bias: torch.Tensor,  # (B, P) f32: 0 valid / large negative invalid
    anc: torch.Tensor,  # (B, K, N) int ancestor rows
    step: int,
    num_beams: int,
) -> torch.Tensor:
    """The TPU kernel's math in torch: f32 logits and softmax; the
    probabilities are cast to the value dtype before the f32-accumulated
    value contraction, as the kernel's MXU dots do."""
    BK, _, Hq, D = q.shape
    K = num_beams
    B = BK // K
    Hkv, P = pk.shape[1], pk.shape[2]
    N = gk.shape[3]
    G = Hq // Hkv
    scale = D ** -0.5
    dev = q.device
    qg = q.reshape(B, K, Hkv, G, D).float()
    lp = torch.einsum("bkhgd,bhpd->bkhgp", qg, pk.float()) * scale
    lp = lp + prefix_bias.float()[:, None, None, None, :]
    lg = torch.einsum("bkhgd,bhrnd->bkhgrn", qg, gk.float()) * scale
    rows = torch.arange(K, device=dev)
    live = ((anc[:, :, None, :] == rows[None, None, :, None])
            & (torch.arange(N, device=dev) < step))  # (B, K, R, N)
    lg = torch.where(live[:, :, None, None], lg, torch.full((), NEG_INF, device=dev))
    kc = k_cur.reshape(B, K, Hkv, D).float()
    lc = torch.einsum("bkhgd,bkhd->bkhg", qg, kc) * scale

    m = torch.maximum(torch.maximum(lp.amax(dim=-1), lg.amax(dim=(-2, -1))), lc)
    ep = torch.exp(lp - m[..., None])
    eg = torch.exp(lg - m[..., None, None])
    ec = torch.exp(lc - m)
    denom = ep.sum(dim=-1) + eg.sum(dim=(-2, -1)) + ec

    vdt = pv.dtype
    acc = torch.einsum("bkhgp,bhpd->bkhgd", ep.to(vdt).float(), pv.float())
    acc = acc + torch.einsum("bkhgrn,bhrnd->bkhgd", eg.to(vdt).float(), gv.float())
    vc = v_cur.reshape(B, K, Hkv, D).float()
    ec_v = ec if K == 1 else ec.to(vdt).float()
    acc = acc + ec_v[..., None] * vc[:, :, :, None, :]
    out = (acc / denom[..., None]).to(q.dtype)
    return out.reshape(BK, 1, Hq, D)


def _check(name: str, t: torch.Tensor, shape, dtype) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_cuda:
        raise ValueError(f"{name}: not on a CUDA device")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: not 16-byte aligned")


@functools.lru_cache(maxsize=1)
def _launcher():
    """The kernel's C entry point, built and typed once per process."""
    from .. import kernels

    fn = kernels.load("beam_attention").beam_attention_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch(q, pk, pv, gk, gv, k_cur, v_cur, prefix_bias, anc, step, num_beams):
    BK, _, Hq, D = q.shape
    K = num_beams
    if BK % K:
        raise ValueError(f"q rows {BK} not a multiple of num_beams {K}")
    B = BK // K
    Hkv, P = pk.shape[1], pk.shape[2]
    N = gk.shape[3]
    if Hq % Hkv:
        raise ValueError(f"Hq {Hq} not a multiple of Hkv {Hkv}")
    G = Hq // Hkv
    if D not in (64, 128):
        raise ValueError(f"head_dim {D}: the kernel takes 64 or 128")
    if not 1 <= G <= 32:
        raise ValueError(f"GQA group {G}: the kernel takes 1..32 q-heads per kv head")
    if not 0 <= step <= N:
        raise ValueError(f"step {step} outside [0, {N}]")
    bf16 = torch.bfloat16
    _check("q", q, (BK, 1, Hq, D), bf16)
    _check("pk", pk, (B, Hkv, P, D), bf16)
    _check("pv", pv, (B, Hkv, P, D), bf16)
    _check("gk", gk, (B, Hkv, K, N, D), bf16)
    _check("gv", gv, (B, Hkv, K, N, D), bf16)
    _check("k_cur", k_cur, (BK, Hkv, D), bf16)
    _check("v_cur", v_cur, (BK, Hkv, D), bf16)
    _check("prefix_bias", prefix_bias, (B, P), torch.float32)
    _check("anc", anc, (B, K, N), torch.int32)
    devices = {t.device for t in (q, pk, pv, gk, gv, k_cur, v_cur, prefix_bias, anc)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")

    out = torch.empty_like(q)
    with torch.cuda.device(q.device):  # the launch goes to the current device
        rc = _launcher()(
            q.data_ptr(), pk.data_ptr(), pv.data_ptr(), gk.data_ptr(), gv.data_ptr(),
            k_cur.data_ptr(), v_cur.data_ptr(), prefix_bias.data_ptr(), anc.data_ptr(),
            out.data_ptr(), B, K, G, Hkv, P, N, D, int(step), float(D ** -0.5),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"beam_attention kernel launch failed: CUDA error {rc}")
    beam_decode_attention.launches += 1
    return out


def beam_decode_attention(
    q: torch.Tensor,
    pk: torch.Tensor,
    pv: torch.Tensor,
    gk: torch.Tensor,
    gv: torch.Tensor,
    k_cur: torch.Tensor,
    v_cur: torch.Tensor,
    prefix_bias: torch.Tensor,
    anc: torch.Tensor,
    step: int,
    num_beams: int,
) -> torch.Tensor:
    """Fused split-cache beam attention, (B*K, 1, Hq, D). Equal to the
    reorder route (`_merged_beam_attention` of the JAX package) on a cache
    physically reordered so that row k holds beam k's ancestor chain.
    CPU tensors take the plain version; CUDA tensors (bf16, contiguous,
    f32 bias, int32 anc) launch the kernel and count the launch in
    `beam_decode_attention.launches`."""
    if q.device.type == "cpu":
        return beam_decode_attention_plain(q, pk, pv, gk, gv, k_cur, v_cur,
                                           prefix_bias, anc, step, num_beams)
    return _launch(q, pk, pv, gk, gv, k_cur, v_cur, prefix_bias, anc, step, num_beams)


beam_decode_attention.launches = 0
