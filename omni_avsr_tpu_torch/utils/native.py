"""ctypes bindings for the repository's host-side C++ library
(`native/editdist.cpp`): word edit distance, BLEU n-gram statistics,
frame-budget bucket packing, the auction solver of balanced assignment and
fairseq's token-block utilities (port of `omni_avsr_tpu/utils/native.py`).

The library is built with `g++` at first use into `build/native/` at the
repository root, under a file name that carries a hash of the source, so
an edited source is rebuilt; `native/` itself is never written. If the
build fails, the first call raises with the compiler's output: nothing
falls back to Python quietly. The pure-Python functions beside each entry
point (`*_py`) are the plain references the tests hold the library to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import random
import subprocess
import threading
import warnings
from collections import Counter
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = ROOT / "native" / "editdist.cpp"
BUILD_DIR = ROOT / "build" / "native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libomniavsr-{digest}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCE} (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The library, built on first use; raises if it does not build."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.edit_distance_ids.restype = ctypes.c_int64
            lib.edit_distance_ids.argtypes = [_I32P, ctypes.c_int64, _I32P, ctypes.c_int64]
            lib.bleu_add.restype = None
            lib.bleu_add.argtypes = [_I32P, ctypes.c_int64, _I32P, ctypes.c_int64, _I64P]
            lib.bucket_pack.restype = ctypes.c_int64
            lib.bucket_pack.argtypes = [_I64P, _I64P, ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_int64, ctypes.c_int64, _I64P, _I64P]
            lib.balanced_assignment.restype = ctypes.c_int64
            lib.balanced_assignment.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                                                ctypes.c_int64, _I64P]
            lib.token_block_slices.restype = ctypes.c_int64
            lib.token_block_slices.argtypes = [_I64P, ctypes.c_int64, ctypes.c_int64,
                                               ctypes.c_int64, ctypes.c_int64, _I64P]
            lib.block_to_dataset_index.restype = None
            lib.block_to_dataset_index.argtypes = [_I64P, ctypes.c_int64, _I64P,
                                                   ctypes.c_int64, _I64P]
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def edit_distance_native(a: Sequence[int], b: Sequence[int]) -> int:
    aa = np.ascontiguousarray(a, np.int32)
    bb = np.ascontiguousarray(b, np.int32)
    return int(load().edit_distance_ids(_ptr(aa, ctypes.c_int32), len(aa),
                                        _ptr(bb, ctypes.c_int32), len(bb)))


def edit_distance_py(a: Sequence[int], b: Sequence[int]) -> int:
    """Levenshtein distance with unit costs, row by row."""
    a, b = list(a), list(b)
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, start=1):
        cur = [i]
        for j, y in enumerate(b, start=1):
            cur.append(min(prev[j - 1] + (x != y), prev[j] + 1, cur[j - 1] + 1))
        prev = cur
    return prev[-1]


def bleu_stats_native(ref: Sequence[int], hyp: Sequence[int], stats: np.ndarray) -> None:
    """Accumulate clipped n-gram BLEU statistics (orders 1-4) into the int64
    stats[10]: [ref_len, hyp_len, match1, count1, ..., match4, count4]."""
    if stats.dtype != np.int64 or stats.shape != (10,) or not stats.flags.c_contiguous:
        raise ValueError(f"stats must be a contiguous int64 (10,), not {stats.dtype} {stats.shape}")
    aa = np.ascontiguousarray(ref, np.int32)
    bb = np.ascontiguousarray(hyp, np.int32)
    load().bleu_add(_ptr(aa, ctypes.c_int32), len(aa), _ptr(bb, ctypes.c_int32), len(bb),
                    _ptr(stats, ctypes.c_int64))


def bleu_stats_py(ref: Sequence[int], hyp: Sequence[int], stats: np.ndarray) -> None:
    ref, hyp = list(ref), list(hyp)
    stats[0] += len(ref)
    stats[1] += len(hyp)
    for k in range(1, 5):
        if len(hyp) - k + 1 <= 0:
            continue
        refc = Counter(tuple(ref[i:i + k]) for i in range(len(ref) - k + 1))
        hypc = Counter(tuple(hyp[i:i + k]) for i in range(len(hyp) - k + 1))
        stats[2 + 2 * (k - 1)] += sum(min(c, refc[g]) for g, c in hypc.items())
        stats[3 + 2 * (k - 1)] += len(hyp) - k + 1


def bucket_batches_native(lengths: Sequence[int], max_frames: int, num_buckets: int,
                          shuffle: bool, batch_size: int, seed: int) -> List[List[int]]:
    """Bucketize the lengths into `num_buckets` equal-width buckets, visit
    the samples in a seeded permutation (`shuffle`) or longest first, order
    them by bucket (stable) and pack greedily until `max_frames` frames or
    `batch_size` samples (0: no limit). Every sample must fit the budget."""
    n = len(lengths)
    ls = np.ascontiguousarray(lengths, np.int64)
    if n and int(ls.max()) > max_frames:
        raise ValueError(f"a sample of {int(ls.max())} frames exceeds max_frames={max_frames}")
    if shuffle:
        order = np.random.RandomState(seed).permutation(n).astype(np.int64)
    else:
        order = np.argsort(-ls, kind="stable").astype(np.int64)
    starts = np.zeros(n + 1, np.int64)
    members = np.zeros(n, np.int64)
    nb = int(load().bucket_pack(_ptr(ls, ctypes.c_int64), _ptr(order, ctypes.c_int64), n,
                                max_frames, num_buckets, batch_size,
                                _ptr(starts, ctypes.c_int64), _ptr(members, ctypes.c_int64)))
    return [members[starts[i]:starts[i + 1]].tolist() for i in range(nb)]


def bucket_batches_py(lengths: Sequence[int], max_frames: int, num_buckets: int,
                      shuffle: bool = False, batch_size: Optional[int] = None,
                      seed: int = 0) -> List[List[int]]:
    """The Python packer (`omni_avsr_tpu/data/batching.py:31-95`): the same
    buckets and greedy packing, its shuffle a `random.Random(seed)` shuffle
    (another permutation than the library's); a sample over the budget
    becomes a batch of its own, with a warning."""
    lengths = np.asarray(lengths)
    lo, hi = int(lengths.min()), int(lengths.max())
    if hi > max_frames:
        n_long = int((lengths > max_frames).sum())
        warnings.warn(f"{n_long} sample(s) exceed max_frames={max_frames} "
                      f"(longest {hi}); each becomes its own batch")
    boundaries = np.linspace(lo, hi, num_buckets)
    assignments = np.searchsorted(boundaries, lengths, side="left")
    items = [(int(i), int(n), int(b)) for i, (n, b) in enumerate(zip(lengths, assignments))]
    if shuffle:
        random.Random(seed).shuffle(items)
    else:
        items.sort(key=lambda x: x[1], reverse=True)
    items.sort(key=lambda x: x[2])  # stable: keeps the order within a bucket
    batches: List[List[int]] = []
    cur: List[int] = []
    cur_frames = 0
    for idx, length, _ in items:
        if (cur_frames + length > max_frames) or (batch_size and len(cur) == batch_size):
            if cur:
                batches.append(cur)
            cur, cur_frames = [idx], length
        else:
            cur.append(idx)
            cur_frames += length
    if cur:
        batches.append(cur)
    return batches


def balanced_assignment_native(scores: np.ndarray) -> np.ndarray:
    """Balanced linear assignment: each of W workers gets exactly J / W of
    the J jobs, maximising the total score (the auction algorithm of
    fairseq's libbase `balanced_assignment.cpp`, BASE-layer MoE routing),
    on the host, as in the JAX package. scores: float (J, W); returns
    int64 (J,) where positions w*k .. w*k+k-1 hold worker w's jobs."""
    scores = np.ascontiguousarray(scores, np.float32)
    num_jobs, num_workers = scores.shape
    if num_jobs % num_workers:
        raise ValueError(f"{num_workers} workers do not divide {num_jobs} jobs")
    out = np.empty(num_jobs, np.int64)
    rc = load().balanced_assignment(_ptr(scores, ctypes.c_float), num_jobs, num_workers,
                                    _ptr(out, ctypes.c_int64))
    if rc != 0:
        raise RuntimeError("balanced_assignment failed")
    return out


def balanced_assignment_py(scores: np.ndarray) -> np.ndarray:
    """The numpy auction (`omni_avsr_tpu/utils/native.py:200-228`): the same
    iterations as the library, on float64 values."""
    num_jobs, num_workers = scores.shape
    k = num_jobs // num_workers
    max_iterations = 100
    eps = max((scores.max() - scores.min()) / 50.0, 1e-4)
    base = scores.T.astype(np.float64).copy()  # (W, J)
    value = base.copy()
    cost = np.zeros(num_jobs)
    retained = np.zeros(0, np.int64)
    counter = 0
    while True:
        bids = np.zeros_like(base)
        # descending top-(k+1), ties to the lower index
        top_index = np.argsort(-value, axis=1, kind="stable")[:, : k + 1]
        top_values = np.take_along_axis(value, top_index, axis=1)
        incr = top_values[:, :k] - top_values[:, k:] + eps
        np.put_along_axis(bids, top_index[:, :k], incr, axis=1)
        if 0 < counter < max_iterations:
            bids.reshape(-1)[retained] = eps
        high_bids = bids.max(axis=0)
        high_bidders = bids.argmax(axis=0)
        have = high_bids > 0
        if have.all():
            break
        cost += high_bids
        value = base - cost[None, :]
        retained = (high_bidders * num_jobs + np.arange(num_jobs))[have]
        value.reshape(-1)[retained] = (
            base.max() if counter < max_iterations else base.reshape(-1)[retained])
        counter += 1
    return top_index[:, :k].reshape(-1).astype(np.int64)


BLOCK_MODES = {"none": 0, None: 0, "complete": 1, "complete_doc": 2, "eos": 3}


def _block_mode(break_mode: Optional[str]) -> int:
    if break_mode not in BLOCK_MODES:
        raise ValueError(f"Invalid break_mode: {break_mode}")
    return BLOCK_MODES[break_mode]


def token_block_slices_native(sizes: Sequence[int], break_mode: Optional[str], block_size: int,
                              document_sep_len: int = 1) -> np.ndarray:
    """Chop per-sentence token sizes into contiguous (start, end) token
    blocks, fairseq's `token_block_utils_fast.pyx::_get_slice_indices_fast`:
    "none" (or None) fixed windows of `block_size` over the concatenated
    stream, "complete" whole sentences packed greedily up to `block_size`
    (a longer sentence alone), "complete_doc" the same without crossing a
    separator sentence of `document_sep_len` tokens (blocks of <= 1 token
    dropped), "eos" one block a sentence. Returns int64 (num_blocks, 2)."""
    mode = _block_mode(break_mode)
    ls = np.ascontiguousarray(sizes, np.int64)
    n = len(ls)
    total = int(ls.sum())
    max_blocks = max(1, -(-total // block_size) if mode == 0 else n)
    out = np.zeros(2 * max_blocks, np.int64)
    m = int(load().token_block_slices(_ptr(ls, ctypes.c_int64), n, mode, block_size,
                                      document_sep_len, _ptr(out, ctypes.c_int64)))
    return out[:2 * m].reshape(m, 2)


def token_block_slices_py(sizes: Sequence[int], break_mode: Optional[str], block_size: int,
                          document_sep_len: int = 1) -> np.ndarray:
    """The same blocks in Python (`omni_avsr_tpu/utils/native.py:255-283`)."""
    mode = _block_mode(break_mode)
    ls = [int(s) for s in sizes]
    total = sum(ls)
    blocks = []
    if mode == 0:
        blocks = [(i * block_size, min((i + 1) * block_size, total))
                  for i in range(-(-total // block_size))]
    elif mode in (1, 2):
        least = 0 if mode == 1 else 1  # "complete_doc" drops blocks of <= 1 token
        tok = cur = sz = 0
        while sz < len(ls):
            fits = cur + ls[sz] <= block_size or cur == 0
            is_sep = mode == 2 and ls[sz] == document_sep_len
            if fits and not is_sep:
                cur += ls[sz]
                sz += 1
            else:
                if cur > least:
                    blocks.append((tok, tok + cur))
                tok, cur = tok + cur, 0
                if is_sep:
                    tok += ls[sz]
                    sz += 1
        if cur > least:
            blocks.append((tok, tok + cur))
    else:
        tok = 0
        for s in ls:
            blocks.append((tok, tok + s))
            tok += s
    return np.asarray(blocks, np.int64).reshape(len(blocks), 2)


def block_to_dataset_index_native(sizes: Sequence[int], slices: np.ndarray) -> np.ndarray:
    """Each (start, end) token slice in dataset coordinates: (first
    sentence, offset in it, last sentence), fairseq's
    `_get_block_to_dataset_index_fast`. Returns int64 (num_blocks, 3)."""
    ls = np.ascontiguousarray(sizes, np.int64)
    sl = np.ascontiguousarray(slices, np.int64).reshape(-1, 2)
    m = sl.shape[0]
    # the library walks the sentences with one cursor that only moves
    # forward: a slice past the last token would read past `sizes`, and
    # starts out of order would give wrong coordinates
    if m and not (np.all(sl[:, 0] >= 0) and np.all(sl[:, 0] < ls.sum())
                  and np.all(sl[:, 1] >= sl[:, 0]) and np.all(sl[:, 1] <= ls.sum())
                  and np.all(np.diff(sl[:, 0]) >= 0)):
        raise ValueError("slices must lie within the sentences' tokens, in order of their "
                         "starts")
    out = np.zeros(3 * m, np.int64)
    load().block_to_dataset_index(_ptr(ls, ctypes.c_int64), len(ls), _ptr(sl, ctypes.c_int64),
                                  m, _ptr(out, ctypes.c_int64))
    return out.reshape(m, 3)


def block_to_dataset_index_py(sizes: Sequence[int], slices: np.ndarray) -> np.ndarray:
    """The same coordinates by binary search over the sentence offsets
    (`omni_avsr_tpu/utils/native.py:296-303`)."""
    cum = np.concatenate([[0], np.cumsum(np.asarray(sizes, np.int64))])
    sl = np.asarray(slices, np.int64).reshape(-1, 2)
    out = np.zeros((len(sl), 3), np.int64)
    for i, (s, e) in enumerate(sl):
        a = int(np.searchsorted(cum, s, side="right") - 1)
        b = int(np.searchsorted(cum, max(s, e - 1), side="right") - 1)
        out[i] = (a, s - cum[a], b)
    return out
