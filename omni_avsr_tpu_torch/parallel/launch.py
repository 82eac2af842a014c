"""Start N local ranks of a command, one per device, with a file-store
rendezvous (torchrun works too):

    python -m omni_avsr_tpu_torch.parallel.launch --nproc 2 -- \\
        python -m omni_avsr_tpu_torch.cli.train_omni --synthetic 4 --tiny true \\
        --device cpu --mesh-tp 2

Each rank gets RANK, WORLD_SIZE, LOCAL_RANK, OMNI_DIST_INIT (a `file://`
rendezvous in a fresh directory, so no port is probed) and
OMNI_DIST_TIMEOUT; `parallel/distributed.py::maybe_initialize_distributed`
reads them (gloo with `--device cpu`, NCCL on the card, one card per rank).
The launcher waits for every rank, stops them all when one fails or the
time limit passes, and exits with the first failing rank's code.

`RankPool` is the same start-up for a Python process: N ranks that stay up
and run the functions they are handed, one group for many calls (the
port's multi-rank tests).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence


def rank_env(rank: int, world: int, init_file: str, timeout_s: float,
             threads: Optional[int] = None) -> dict:
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               OMNI_DIST_INIT=f"file://{init_file}", OMNI_DIST_TIMEOUT=str(timeout_s))
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    return env


def launch(cmd: Sequence[str], nproc: int, timeout_s: float = 3600.0,
           dist_timeout_s: float = 600.0, threads: Optional[int] = None) -> int:
    """Run `cmd` as `nproc` ranks; returns 0 or the first failing rank's
    exit code (124 when the time limit stopped them)."""
    with tempfile.TemporaryDirectory(prefix="omni_rdzv_") as tmp:
        init_file = os.path.join(tmp, "store")
        procs = [subprocess.Popen(list(cmd), env=rank_env(r, nproc, init_file, dist_timeout_s,
                                                            threads))
                 for r in range(nproc)]
        deadline = time.monotonic() + timeout_s
        rc = 0
        try:
            while True:
                codes = [p.poll() for p in procs]
                failed = [c for c in codes if c not in (None, 0)]
                if failed:
                    rc = failed[0]
                    break
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    rc = 124
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        return rc


def _command(rest: List[str]) -> List[str]:
    if rest and rest[0] == "--":
        rest = rest[1:]
    if not rest:
        raise SystemExit("launch: no command after --")
    if rest[0].startswith("omni_avsr_tpu_torch."):  # a module of the port
        return [sys.executable, "-m", *rest]
    return rest


def main(argv=None) -> int:
    p = argparse.ArgumentParser("omni_avsr_tpu_torch.parallel.launch")
    p.add_argument("--nproc", type=int, required=True, help="ranks to start (one per device)")
    p.add_argument("--timeout", type=float, default=3600.0, help="seconds for the whole run")
    p.add_argument("--dist-timeout", type=float, default=600.0,
                   help="seconds any collective may wait")
    p.add_argument("--threads", type=int, default=None, help="OMP_NUM_THREADS of each rank")
    args, rest = p.parse_known_args(argv)
    return launch(_command(rest), args.nproc, args.timeout, args.dist_timeout, args.threads)


# ---------------------------------------------------------------------------
# a group of ranks that stays up (tests)
# ---------------------------------------------------------------------------

def _worker(rank: int, world: int, init_file: str, timeout_s: float, device: str, inbox,
            outbox) -> None:
    import torch

    torch.set_num_threads(1)
    os.environ.update(rank_env(rank, world, init_file, timeout_s))
    from .distributed import maybe_initialize_distributed

    maybe_initialize_distributed(device=device, timeout_s=timeout_s)
    while True:
        task = inbox.get()
        if task is None:
            break
        fn, args, kwargs = task
        try:
            outbox.put((rank, True, fn(*args, **kwargs)))
        except BaseException as e:  # reported to the caller, the rank stays up
            import traceback

            outbox.put((rank, False, f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))
    import torch.distributed as dist

    dist.destroy_process_group()


class RankPool:
    """`world` ranks of this machine (gloo on the CPU by default), each in
    its own process with one torch thread, initialised once through a file
    store in `workdir`; `run(fn, *args)` runs `fn` on every rank and
    returns the ranks' results in rank order. `fn` must be importable by
    name (a module-level function)."""

    def __init__(self, world: int, workdir: str, timeout_s: float = 60.0, device: str = "cpu"):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world, self.timeout_s = world, timeout_s
        init_file = os.path.join(workdir, "rdzv_store")
        self._outbox = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in range(world)]
        self._procs = [ctx.Process(target=_worker, args=(r, world, init_file, timeout_s, device,
                                                           self._inboxes[r], self._outbox),
                                   daemon=True)
                       for r in range(world)]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable, *args, timeout_s: Optional[float] = None, **kwargs) -> List[Any]:
        import queue

        for q in self._inboxes:
            q.put((fn, args, kwargs))
        results, errors = [None] * self.world, []
        deadline = time.monotonic() + (timeout_s or 4 * self.timeout_s)
        name = getattr(fn, "__name__", fn)
        for _ in range(self.world):
            while True:
                try:
                    rank, ok, value = self._outbox.get(timeout=1.0)
                    break
                except queue.Empty:
                    dead = [r for r, p in enumerate(self._procs) if not p.is_alive()]
                    if dead or time.monotonic() > deadline:
                        self.close()
                        why = f"rank(s) {dead} exited" if dead else "a rank did not answer in time"
                        raise TimeoutError(f"{name}: {why}") from None
            if ok:
                results[rank] = value
            else:
                errors.append(f"rank {rank}: {value}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return results

    def close(self) -> None:
        for q, p in zip(self._inboxes, self._procs):
            if p.is_alive():
                q.put(None)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


if __name__ == "__main__":
    sys.exit(main())
