"""Multi-process start-up (port of `omni_avsr_tpu/parallel/distributed.py`).

The JAX package starts one process per host, each driving its devices;
the port starts one rank per device (`torch.distributed`, NCCL on the
card, gloo with `device="cpu"`). The reference trains multi-node with
lightning DDP over SLURM; fairseq infers the rendezvous from the
environment (`distributed/utils.py:46-139`), and so does
`maybe_initialize_distributed`, in fairseq's order:

  1. explicit flags: `--num-nodes N --coordinator-address host:port
     --node-rank r` (`tcp://host:port`). The JAX package's N counts
     processes, one per host driving all its devices; here it counts
     ranks, one per device, so on a host with several devices each rank
     needs its LOCAL_RANK (torchrun, SLURM or `parallel/launch.py`) and
     the flags alone raise rather than drive one device of the host;
  2. torchrun's environment: RANK, WORLD_SIZE, LOCAL_RANK and
     MASTER_ADDR / MASTER_PORT (`env://`), or the launcher of this package
     (`parallel/launch.py`), which adds OMNI_DIST_INIT, a `file://`
     rendezvous;
  3. SLURM's: SLURM_PROCID, SLURM_NTASKS (SLURM_LOCALID), with
     MASTER_ADDR / MASTER_PORT.

Each rank feeds only its rows of the deterministic global batch
(`host_shard_slice`, `global_batch_from_local`).
"""

from __future__ import annotations

import atexit
import datetime
import os
from typing import Any, Optional

import torch
import torch.distributed as dist


def resolve_rendezvous(num_nodes: int = 1, coordinator_address: Optional[str] = None,
                       node_rank: Optional[int] = None, environ=None, local_devices: int = 1):
    """(init_method, world_size, rank, local_rank) of the flags and the
    environment, in fairseq's order, or None when one process is asked for.
    `local_devices` is the number of devices this host shows."""
    env = os.environ if environ is None else environ

    def geti(name):
        v = env.get(name)
        return int(v) if v not in (None, "") else None

    if coordinator_address is not None or num_nodes > 1:
        if coordinator_address is None:
            if not (env.get("MASTER_ADDR") and env.get("MASTER_PORT")):
                raise ValueError("--num-nodes > 1 needs --coordinator-address host:port "
                                 "(or MASTER_ADDR / MASTER_PORT)")
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        if node_rank is None:
            node_rank = next((v for v in (geti("RANK"), geti("SLURM_PROCID"), geti("NODE_RANK"))
                              if v is not None), 0)
        local = next((v for v in (geti("LOCAL_RANK"), geti("SLURM_LOCALID")) if v is not None),
                     None)
        if local is None and num_nodes > 1 and local_devices > 1:
            raise ValueError(
                f"--num-nodes {num_nodes} counts ranks, one per device (the JAX package's "
                f"counts hosts), and this host shows {local_devices} devices but no "
                f"LOCAL_RANK: start one rank per device with torchrun or "
                f"`python -m omni_avsr_tpu_torch.parallel.launch`")
        return f"tcp://{coordinator_address}", max(num_nodes, 1), node_rank, local or 0
    if geti("RANK") is not None and geti("WORLD_SIZE") is not None:
        init = env.get("OMNI_DIST_INIT") or "env://"
        return init, geti("WORLD_SIZE"), geti("RANK"), geti("LOCAL_RANK") or 0
    if geti("SLURM_PROCID") is not None and (geti("SLURM_NTASKS") or 1) > 1:
        if not (env.get("MASTER_ADDR") and env.get("MASTER_PORT")):
            raise ValueError("a SLURM job of several tasks needs MASTER_ADDR / MASTER_PORT "
                             "or --coordinator-address")
        return ("env://", geti("SLURM_NTASKS"), geti("SLURM_PROCID"),
                geti("SLURM_LOCALID") or 0)
    return None


def maybe_initialize_distributed(
    num_nodes: int = 1,
    coordinator_address: Optional[str] = None,
    node_rank: Optional[int] = None,
    device="cuda",
    timeout_s: Optional[float] = None,
) -> bool:
    """Initialise the default process group when several ranks are asked
    for (`resolve_rendezvous`). Returns True iff it is (already or newly)
    initialised. The backend is NCCL for a CUDA `device` and gloo for the
    CPU; on the card the rank's device is set to LOCAL_RANK before any
    collective. `timeout_s` (else OMNI_DIST_TIMEOUT, else 600 s) bounds
    every collective. The group it starts is destroyed at the process's
    exit (`atexit`), before the interpreter tears its modules down, so the
    group and its store never end in that teardown's arbitrary order."""
    if dist.is_initialized():
        return True
    cuda = torch.device(device).type == "cuda"
    rv = resolve_rendezvous(num_nodes, coordinator_address, node_rank,
                            local_devices=torch.cuda.device_count() if cuda else 1)
    if rv is None:
        return False
    init_method, world, rank, local_rank = rv
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL needs a CUDA device; pass --device cpu for gloo")
        torch.cuda.set_device(local_rank)
    if timeout_s is None:
        timeout_s = float(os.environ.get("OMNI_DIST_TIMEOUT", "600"))
    kwargs = dict(backend="nccl" if cuda else "gloo", init_method=init_method,
                  world_size=world, rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    if cuda:
        kwargs["device_id"] = torch.device("cuda", local_rank)
    dist.init_process_group(**kwargs)
    atexit.register(_destroy_at_exit)
    return True


def _destroy_at_exit() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device(device="cuda") -> torch.device:
    """This rank's device: `cuda:LOCAL_RANK` on the card, else `device`."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def is_primary() -> bool:
    """True on the rank that writes checkpoints and logs."""
    return process_index() == 0


def host_shard_slice(n_items: int, index: Optional[int] = None,
                     count: Optional[int] = None) -> slice:
    """The contiguous slice of a global item list for rank `index` of
    `count` (this process of the world by default): rank p takes items
    [p*k, (p+1)*k) with k = ceil(n/P) (the last may get fewer).
    Deterministic and identical on every rank."""
    p = process_index() if index is None else index
    P_ = process_count() if count is None else count
    k = -(-n_items // P_)
    return slice(p * k, min(n_items, (p + 1) * k))


def global_batch_from_local(mesh, local_batch: Any, device=None) -> Any:
    """This rank's rows as tensors on its device (`device`, else the
    mesh's). The rows are already this rank's (`host_shard_slice`); the
    global batch is their concatenation over dp, which no rank assembles."""
    if device is None:
        device = "cuda" if mesh is not None and mesh.device_type == "cuda" else "cpu"
        device = local_device(device)
    return {k: (torch.as_tensor(v).to(device)
                if not isinstance(v, (int, float, str, list)) and v is not None else v)
            for k, v in local_batch.items()}
