"""Device mesh and batch helpers (port of `omni_avsr_tpu/parallel/mesh.py`).

The JAX package is single-controller SPMD: one process drives many
devices and GSPMD inserts the collectives. The port runs one rank per
device (`torch.distributed`), and the mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the world's ranks in the
JAX mesh's shape and axis order, `(dp[, pp][, ep], tp)`: pp and ep appear
only when their size is above 1. Each axis name gives the process group of
the ranks that differ only in that coordinate (`axis`).

`batch_sharding`, `replicated` and `shard_batch` keep their names: with
one rank per device a "sharded" batch is the rank's own rows, so they
return row slices rather than shardings.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.distributed as dist

from ..config import MeshConfig

AXIS_DP = "dp"
AXIS_TP = "tp"
AXIS_PP = "pp"
AXIS_EP = "ep"


def make_mesh(cfg: Optional[MeshConfig] = None, device_type: Optional[str] = None):
    """The (dp[, pp][, ep], tp) DeviceMesh over the initialised world; with
    cfg=None every rank is dp. `device_type` defaults to "cuda" under NCCL
    and "cpu" otherwise."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel/distributed.py::maybe_initialize_distributed)")
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if cfg is None:
        cfg = MeshConfig(dp=n, tp=1)
    pp, ep = getattr(cfg, "pp", 1), getattr(cfg, "ep", 1)
    total = cfg.dp * cfg.tp * pp * ep
    assert total == n, f"mesh dp={cfg.dp} pp={pp} ep={ep} tp={cfg.tp} != {n} devices"
    shape = [cfg.dp] + ([pp] if pp > 1 else []) + ([ep] if ep > 1 else []) + [cfg.tp]
    names = ([AXIS_DP] + ([AXIS_PP] if pp > 1 else [])
             + ([AXIS_EP] if ep > 1 else []) + [AXIS_TP])
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh, a JAX-style mesh (`.shape` a
    mapping) or a plain mapping."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return dict(mesh.shape)
    return dict(zip(names, tuple(mesh.shape)))


class Axis(NamedTuple):
    """One mesh axis as this rank sees it: its process group (None when the
    mesh lacks the axis), its size and this rank's coordinate. An axis of
    size 1 is active: its collectives run (at world size 1 on the card, as
    trivial NCCL launches), and change no value."""

    group: Any
    size: int
    rank: int

    @property
    def active(self) -> bool:
        return self.group is not None


NO_AXIS = Axis(None, 1, 0)


def axis(mesh, name: str) -> Axis:
    """This rank's view of the mesh axis `name` (NO_AXIS when absent)."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return NO_AXIS
    size = mesh.size(mesh.mesh_dim_names.index(name))
    return Axis(mesh.get_group(name), size, mesh.get_local_rank(name))


def batch_sharding(mesh):
    """`rows(n)`: the slice of an n-row global batch this rank holds, its
    contiguous dp block (the leading axis over dp, as `P(dp)` shards it)."""
    ax = axis(mesh, AXIS_DP)

    def rows(n: int) -> slice:
        assert n % ax.size == 0, f"global batch {n} not divisible by dp={ax.size}"
        k = n // ax.size
        return slice(ax.rank * k, (ax.rank + 1) * k)

    return rows


def replicated(mesh):
    """`rows(n)`: every rank holds every row."""
    return lambda n: slice(0, n)


def shard_batch(mesh, batch: Dict[str, Any], device=None) -> Dict[str, Any]:
    """This rank's rows of a global batch of arrays, as tensors on `device`
    (the leading axis is the batch)."""
    rows = batch_sharding(mesh)
    out = {}
    for k, v in batch.items():
        if isinstance(v, (int, float, str, list)) or v is None:
            out[k] = v
            continue
        t = torch.as_tensor(v)
        out[k] = t[rows(t.shape[0])].to(device) if device is not None else t[rows(t.shape[0])]
    return out
