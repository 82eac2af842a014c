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
`csrc/beam_attention.cu` (built with nvcc on first use) or raises. The
kernel splits the key list [prefix | generated | current] over the blocks
of a cluster, `plan_splits` of them, and merges their partial softmaxes;
`beam_decode_attention_split` is that schedule in torch.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..kernels import check, load, sm_count

NEG_INF = -1e30  # the TPU kernel's mask value for generated/current lanes
KEY_TILE = 64  # keys per tile of the kernel
ROW_CHUNK = 64  # query rows (K * G of one kv head) per block
MAX_SPLITS = 8  # blocks of one cluster
SMEM_LIMIT = 232448  # bytes of shared memory a block may opt in to on sm_90

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                                          ctypes.c_void_p]


def smem_bytes(K: int, N: int, D: int) -> int:
    """The kernel's shared memory (`csrc/beam_attention.cu::Cfg::smem`):
    two stages of a 64-key K and V tile (rows padded by 8 bf16), each key's
    code and bias, the rows' partial max and sum, the tile's beam masks,
    and the ancestor table, K rows of N + 1 ints."""
    stages = 2 * 2 * KEY_TILE * (D + 8) * 2
    meta = 2 * KEY_TILE * (4 + 4) + 2 * ROW_CHUNK * 4 + KEY_TILE * 8
    return stages + meta + K * (N + 1) * 4


def max_beams(N: int, D: int) -> int:
    """The most beams the kernel takes at N generated slots and head dim
    D: the ancestor table is what grows with K."""
    return (SMEM_LIMIT - smem_bytes(0, N, D)) // ((N + 1) * 4)


def plan_splits(B: int, Hkv: int, rows: int, P: int, K: int, step: int, sms: int) -> int:
    """The number of blocks (one cluster) that share the key list of one
    (batch item, kv head, chunk of 64 query rows): each takes a contiguous
    run of 64-key tiles of [prefix P | generated K * step | current K]. As
    many as there are tiles, so each block walks as few as possible, up to
    the cluster's 8; fewer once B * Hkv * chunks alone gives two blocks per
    SM, where more splits would only add merging."""
    tiles = -(-(P + K * step + K) // KEY_TILE)  # integer ceilings: the wrapper's host cost
    units = B * Hkv * -(-rows // ROW_CHUNK)
    return max(1, min(MAX_SPLITS, tiles, -(-2 * sms // units)))


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


_splits = functools.lru_cache(maxsize=1024)(plan_splits)  # the wrapper's: once per shape


def beam_decode_attention_split(q, pk, pv, gk, gv, k_cur, v_cur, prefix_bias, anc, step: int,
                                num_beams: int, splits: int) -> torch.Tensor:
    """The kernel's schedule in torch, for the tests: the key list
    [prefix | generated rows r < K at slots n < step, r-major | current
    tokens] of each (batch item, kv head), masked per query row as the
    kernel masks it, cut into 64-key tiles, the tiles split into `splits`
    contiguous runs (run s: tiles s * n / splits to (s + 1) * n / splits);
    each run's partial (max, sum, unnormalised acc) with its max starting at
    the mask value, then the merge. Equal to the plain version up to the
    order of the sums."""
    BK, _, Hq, D = q.shape
    K = num_beams
    B = BK // K
    Hkv, P = pk.shape[1], pk.shape[2]
    G = Hq // Hkv
    R, dev = K * G, q.device
    qg = q.reshape(B, K, Hkv, G, D).permute(0, 2, 1, 3, 4).reshape(B, Hkv, R, D).float()

    def key_list(prefix, gen, cur):
        chain = gen[:, :, :, :step].reshape(B, Hkv, K * step, D)
        return torch.cat([prefix, chain, cur.reshape(B, K, Hkv, D).transpose(1, 2)], dim=2)

    keys, vals = key_list(pk, gk, k_cur), key_list(pv, gv, v_cur)
    T = P + K * step + K
    beam = torch.arange(R, device=dev) // G
    j = torch.arange(K * step, device=dev)
    live_gen = anc[:, beam][:, :, j % step] == (j // step)  # (B, R, K * step)
    live_cur = (torch.arange(K, device=dev)[None] == beam[:, None]).expand(B, R, K)
    live = torch.cat([torch.ones(B, R, P, dtype=torch.bool, device=dev), live_gen, live_cur], -1)
    bias = torch.cat([prefix_bias.float(), torch.zeros(B, T - P, device=dev)], dim=-1)
    logits = torch.einsum("bhrd,bhtd->bhrt", qg, keys.float()) * D ** -0.5
    logits = torch.where(live[:, None], logits + bias[:, None, None], torch.full((), NEG_INF,
                                                                                 device=dev))
    n = math.ceil(T / KEY_TILE)
    ms, ls, accs = [], [], []
    for s in range(splits):
        lo, hi = min(T, s * n // splits * KEY_TILE), min(T, (s + 1) * n // splits * KEY_TILE)
        part = logits[..., lo:hi]
        m = torch.clamp(part.amax(dim=-1), min=NEG_INF) if hi > lo else torch.full(
            logits.shape[:-1], NEG_INF, device=dev)
        e = torch.exp(part - m[..., None])
        ms.append(m)
        ls.append(e.sum(dim=-1))
        accs.append(torch.einsum("bhrt,bhtd->bhrd", e.to(pv.dtype).float(),
                                 vals[:, :, lo:hi].float()))
    m_all = torch.stack(ms).amax(dim=0)
    w = [torch.exp(m - m_all) for m in ms]
    denom = sum(wi * li for wi, li in zip(w, ls))
    out = sum(wi[..., None] * ai for wi, ai in zip(w, accs)) / denom[..., None]
    out = out.reshape(B, Hkv, K, G, D).permute(0, 2, 1, 3, 4).to(q.dtype)
    return out.reshape(BK, 1, Hq, D)


@functools.lru_cache(maxsize=1)
def _launcher():
    """The kernel's C entry point, built and typed once per process."""
    fn = load("beam_attention").beam_attention_launch
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
    if smem_bytes(K, N, D) > SMEM_LIMIT:
        raise ValueError(f"num_beams {K} at {N} generated slots: the ancestor table, {K} x "
                         f"{N + 1} ints, does not fit the kernel's shared memory of "
                         f"{SMEM_LIMIT} bytes (at most {max_beams(N, D)} beams)")
    if not 0 <= step <= N:
        raise ValueError(f"step {step} outside [0, {N}]")
    bf16 = torch.bfloat16
    check("q", q, (BK, 1, Hq, D), bf16)
    check("pk", pk, (B, Hkv, P, D), bf16)
    check("pv", pv, (B, Hkv, P, D), bf16)
    check("gk", gk, (B, Hkv, K, N, D), bf16)
    check("gv", gv, (B, Hkv, K, N, D), bf16)
    check("k_cur", k_cur, (BK, Hkv, D), bf16)
    check("v_cur", v_cur, (BK, Hkv, D), bf16)
    check("prefix_bias", prefix_bias, (B, P), torch.float32)
    check("anc", anc, (B, K, N), torch.int32)
    devices = {t.device for t in (q, pk, pv, gk, gv, k_cur, v_cur, prefix_bias, anc)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    dev = q.device

    out = torch.empty_like(q)
    splits = _splits(B, Hkv, K * G, P, K, step, sm_count(dev))
    with torch.cuda.device(dev):  # the launch goes to the current device
        rc = _launcher()(
            q.data_ptr(), pk.data_ptr(), pv.data_ptr(), gk.data_ptr(), gv.data_ptr(),
            k_cur.data_ptr(), v_cur.data_ptr(), prefix_bias.data_ptr(), anc.data_ptr(),
            out.data_ptr(), B, K, G, Hkv, P, N, D, int(step), float(D ** -0.5), splits,
            torch.cuda.current_stream(dev).cuda_stream)
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
