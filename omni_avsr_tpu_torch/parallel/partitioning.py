"""Parameter partition specs for the model zoo (port of
`omni_avsr_tpu/parallel/partitioning.py`).

The rule tables are the JAX package's, path regex -> spec, first match
wins, with a plain tuple of axis names (or None) in place of
`PartitionSpec`. Specs address a leaf's trailing dims and are padded with
None on the left (the stacked-layer axis is never sharded by a rule).

GSPMD turns a spec tree into collectives by itself; the port runs one rank
per device, so a spec tree here says which slice of each leaf this rank
keeps (`shard_params`) and, per block, whether the block runs
tensor-parallel (`tp_blocks`): GSPMD computes a block correctly when
`clamp_specs_to_shapes` replicates one of its leaves and shards the
others, a hand-written tensor-parallel block does not, so a block whose
tp leaves do not all divide runs replicated (`coherent_specs`).
`named_shardings` has no counterpart: there is no sharding object to name.
"""

from __future__ import annotations

import math
import re
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch

from .mesh import AXIS_DP, AXIS_EP, AXIS_TP, mesh_sizes

Spec = Tuple[Optional[object], ...]

# Order matters: first match wins. Weights are (in, out).
LLM_RULES: List[Tuple[str, Spec]] = [
    # attention: shard the head dim (out-features of q/k/v, in-features of o)
    (r".*attn\.q\.w$", (None, AXIS_TP)),
    (r".*attn\.k\.w$", (None, AXIS_TP)),
    (r".*attn\.v\.w$", (None, AXIS_TP)),
    (r".*attn\.q\.b$", (AXIS_TP,)),
    (r".*attn\.k\.b$", (AXIS_TP,)),
    (r".*attn\.v\.b$", (AXIS_TP,)),
    (r".*attn\.o\.w$", (AXIS_TP, None)),
    # LoRA: up-projections shard with their base matrices; downs replicate
    (r".*lora.*up_q\.w$", (None, AXIS_TP)),
    (r".*lora.*up_v\.w$", (None, AXIS_TP)),
    # MLP: gate/up shard out-features, down shards in-features
    (r".*mlp\.gate\.w$", (None, AXIS_TP)),
    (r".*mlp\.up\.w$", (None, AXIS_TP)),
    (r".*mlp\.down\.w$", (AXIS_TP, None)),
    # embeddings / head: shard the vocab axis of the unembedding
    (r"^embed\.w$", (None, None)),
    (r"^lm_head\.w$", (None, AXIS_TP)),
]

# Encoder towers: replicated by default, their FFNs sharded when tp > 1.
ENCODER_RULES: List[Tuple[str, Spec]] = [
    (r".*fc1\.w$", (None, AXIS_TP)),
    (r".*fc2\.w$", (AXIS_TP, None)),
    (r".*fc1\.b$", (AXIS_TP,)),
]

# FSDP / ZeRO-3: additionally shard every large matrix over dp on its row dim.
FSDP_EXTRA_RULES: List[Tuple[str, Spec]] = [
    (r".*attn\.q\.w$", (AXIS_DP, AXIS_TP)),
    (r".*attn\.k\.w$", (AXIS_DP, AXIS_TP)),
    (r".*attn\.v\.w$", (AXIS_DP, AXIS_TP)),
    (r".*attn\.o\.w$", (AXIS_TP, AXIS_DP)),
    (r".*mlp\.gate\.w$", (AXIS_DP, AXIS_TP)),
    (r".*mlp\.up\.w$", (AXIS_DP, AXIS_TP)),
    (r".*mlp\.down\.w$", (AXIS_TP, AXIS_DP)),
    (r"^embed\.w$", (AXIS_DP, None)),
    (r"^lm_head\.w$", (AXIS_DP, AXIS_TP)),
    (r".*fc1\.w$", (AXIS_DP, AXIS_TP)),
    (r".*fc2\.w$", (AXIS_TP, AXIS_DP)),
] + LLM_RULES

# Expert parallel (MoE decoder, `models/moe.py`): the expert dim over ep.
MOE_EP_RULES: List[Tuple[str, Spec]] = [
    (r".*moe\.experts\.(gate|up|down)\.w$", (AXIS_EP, None, None)),
]

# Serving: int8 scales shard with their weight's out dim, replicate where the
# out dim is the contracted one (o, down).
LLM_DECODE_RULES: List[Tuple[str, Spec]] = [
    (r".*attn\.(q|k|v)\.s$", (AXIS_TP,)),
    (r".*mlp\.(gate|up)\.s$", (AXIS_TP,)),
    (r"^lm_head\.s$", (AXIS_TP,)),
] + LLM_RULES

ENCODER_DECODE_RULES: List[Tuple[str, Spec]] = [
    (r".*fc1\.s$", (AXIS_TP,)),
] + ENCODER_RULES


def _spec_for(path: str, rules: List[Tuple[str, Spec]], ndim: int) -> Spec:
    for pattern, spec in rules:
        if re.match(pattern, path):
            if len(spec) <= ndim:
                return spec
            break
    return ()


def _tree_specs(tree: Any, rules: List[Tuple[str, Spec]], prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _tree_specs(v, rules, f"{prefix}.{k}" if prefix else k)
                for k, v in tree.items()}
    ndim = tree.ndim if hasattr(tree, "ndim") else len(tree.shape)
    spec = _spec_for(prefix, rules, ndim)
    if len(spec) and ndim > len(spec):
        spec = (None,) * (ndim - len(spec)) + tuple(spec)
    return spec


def llm_partition_specs(params: Any, fsdp: bool = False, ep: bool = False) -> Any:
    rules = FSDP_EXTRA_RULES if fsdp else LLM_RULES
    if ep:
        rules = MOE_EP_RULES + rules
    return _tree_specs(params, rules)


def encoder_partition_specs(params: Any) -> Any:
    return _tree_specs(params, ENCODER_RULES)


def decode_partition_specs(merged: Any) -> Any:
    """Specs of a merged (and possibly int8) serving tree: the LLM matmuls
    and the encoder FFNs over tp, the rest replicated."""
    out = {}
    for k, v in merged.items():
        if k == "llm":
            out[k] = _tree_specs(v, LLM_DECODE_RULES)
        elif k in ("whisper", "avhubert"):
            out[k] = _tree_specs(v, ENCODER_DECODE_RULES)
        else:
            out[k] = _tree_specs(v, [])
    return out


def _axis_size(sizes: Dict[str, int], ax) -> int:
    names = ax if isinstance(ax, tuple) else (ax,)
    return math.prod(sizes.get(n, 1) for n in names)


def clamp_specs_to_shapes(mesh, params: Any, specs: Any) -> Any:
    """Drop sharding on any dim whose size the mesh axis does not divide;
    the leaf replicates that dim, with the JAX package's warning."""
    sizes = mesh_sizes(mesh)

    def one(x, s):
        if not len(s):
            return s
        out, changed = [], False
        for dim, ax in enumerate(s):
            if ax is not None and x.shape[dim] % _axis_size(sizes, ax):
                out.append(None)
                changed = True
            else:
                out.append(ax)
        if changed:
            warnings.warn(
                f"replicating dim(s) of leaf shape {tuple(x.shape)}: {s} does not "
                f"divide under mesh {sizes}", stacklevel=3)
        return tuple(out)

    return _map2(one, params, specs)


def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def _leaves(specs, prefix: str = ""):
    if isinstance(specs, dict):
        for k, v in specs.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, specs


def block_of(path: str) -> Optional[str]:
    """The tensor-parallel block (`collectives.Parallel.tp_blocks`) a leaf
    of the merged tree belongs to, by its dotted path."""
    if path.startswith("llm."):
        if ".attn." in path or re.match(r".*lora.*up_(q|v)\.w$", path):
            return "llm.attn"
        if ".mlp." in path:
            return "llm.mlp"
        if path.startswith("llm.lm_head."):
            return "llm.lm_head"
        return None
    for tower in ("whisper", "avhubert"):
        if path.startswith(tower + ".") and re.search(r"\.fc[12]\.", path) and ".lora" not in path:
            return f"{tower}.ffn"
    return None


def _has(spec: Spec, name: str) -> bool:
    return any(ax == name or (isinstance(ax, tuple) and name in ax) for ax in spec)


def coherent_specs(specs: Any, prefix: str = "", replicate=()) -> Tuple[Any, frozenset]:
    """(specs, tp blocks): each block whose tp-sharded leaves are all still
    sharded after `clamp_specs_to_shapes` runs tensor-parallel; in every
    other block, and in the blocks of `replicate` (the attention when its
    head counts do not divide tp), the tp axis is dropped from every leaf,
    so the block runs replicated and skips its all-reduce. `prefix` is the
    tree's place in the merged tree ("llm" for an LLM tree)."""
    def path(p):
        return f"{prefix}.{p}" if prefix else p

    # a block with a rule on tp: every leaf the rules shard must keep it
    want: Dict[str, bool] = {}
    for p, s in _leaves(specs):
        b = block_of(path(p))
        if b is None:
            continue
        rules = _rule_has_tp(path(p))
        if rules:
            want[b] = want.get(b, True) and _has(s, AXIS_TP)
    blocks = frozenset(b for b, ok in want.items() if ok and b not in replicate)

    def fix(s, p):
        if not len(s) or not _has(s, AXIS_TP) or block_of(path(p)) in blocks:
            return s
        return tuple(None if ax == AXIS_TP else ax for ax in s)

    return _map_specs(fix, specs), blocks


def _rule_has_tp(path: str) -> bool:
    """Whether some rule of the tables shards this leaf over tp."""
    rel = path.split(".", 1)[1] if path.startswith(("llm.", "whisper.", "avhubert.")) else path
    tables = LLM_DECODE_RULES if path.startswith("llm.") else ENCODER_DECODE_RULES
    for pattern, spec in tables:
        if re.match(pattern, rel):
            return AXIS_TP in spec
    return False


def _map_specs(fn, specs, prefix: str = ""):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, f"{prefix}.{k}" if prefix else k) for k, v in specs.items()}
    return fn(specs, prefix)


def _index(sizes: Dict[str, int], coords: Dict[str, int], ax) -> Tuple[int, int]:
    """(shard index, shard count) of a spec entry (an axis or a tuple)."""
    names = ax if isinstance(ax, tuple) else (ax,)
    idx, count = 0, 1
    for n in names:
        idx = idx * sizes.get(n, 1) + coords.get(n, 0)
        count *= sizes.get(n, 1)
    return idx, count


def mesh_coords(mesh) -> Dict[str, int]:
    """{axis name: this rank's coordinate}."""
    if mesh is None:
        return {}
    return {n: mesh.get_local_rank(n) for n in mesh.mesh_dim_names}


def local_slice(x: torch.Tensor, spec: Spec, sizes: Dict[str, int],
                coords: Dict[str, int]) -> torch.Tensor:
    """The slice of `x` the rank at `coords` holds under `spec`, in storage
    of its own: a view would start where the slice starts in the whole
    leaf (rank 1's half of Qwen2.5's 151650 lm_head scales 303300 bytes
    in, which the card's 16-byte loads refuse) and keep the whole leaf
    alive beside it."""
    sliced = False
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        i, n = _index(sizes, coords, ax)
        if n > 1:
            k = x.shape[dim] // n
            x = x.narrow(dim, i * k, k)
            sliced = True
    if sliced:
        return x.clone(memory_format=torch.contiguous_format)
    return x.contiguous() if len(spec) else x


def shard_params(mesh, params: Any, specs: Any, coords: Optional[Dict[str, int]] = None) -> Any:
    """This rank's local slice of every leaf (`coords` overrides the rank's
    mesh coordinates: one process can cut every rank's shard)."""
    sizes = mesh_sizes(mesh)
    coords = mesh_coords(mesh) if coords is None else coords
    return _map2(lambda x, s: local_slice(x, s, sizes, coords), params, specs)


def gather_leaf(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole leaf from every rank's slice (detached): an all-gather
    along each sharded dim over its axis, innermost axis first."""
    from .collectives import all_gather
    from .mesh import axis

    for dim in reversed(range(len(spec))):
        ax = spec[dim]
        if ax is None:
            continue
        for name in reversed(ax if isinstance(ax, tuple) else (ax,)):
            x = all_gather(x, axis(mesh, name), dim)
    return x


def gather_params(mesh, params: Any, specs: Any) -> Any:
    """The whole tree from every rank's slices (every rank gets it)."""
    return _map2(lambda x, s: gather_leaf(x, s, mesh), params, specs)
