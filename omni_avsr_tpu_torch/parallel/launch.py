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
time limit passes, and exits with the first failing rank's code (128 + N
for a rank ended by signal N, as a shell reports it; 124 when the time
limit stopped the run). Each rank's standard error passes through with a
`[rank r]` prefix, and a run that fails ends with one line per rank on
standard error saying how that rank ended and what stopped the run.

`RankPool` is the same start-up for a Python process: N ranks that stay up
and run the functions they are handed, one group for many calls (the
port's multi-rank tests).
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Callable, List, Optional, Sequence


def rank_env(rank: int, world: int, init_file: str, timeout_s: float,
             threads: Optional[int] = None) -> dict:
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               OMNI_DIST_INIT=f"file://{init_file}", OMNI_DIST_TIMEOUT=str(timeout_s))
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    return env


def describe_exit(code: Optional[int]) -> str:
    """How a process ended, from its `Popen.returncode`."""
    if code is None:
        return "still running"
    if code < 0:
        try:
            return f"killed by signal {signal.Signals(-code).name} ({-code})"
        except ValueError:
            return f"killed by signal {-code}"
    return f"exit {code}"


def shell_code(code: int) -> int:
    """A `Popen.returncode` as an exit status: 128 + N for signal N."""
    return 128 - code if code < 0 else code


class _Rank:
    """One rank's process; a thread passes its standard error on with a
    `[rank r]` prefix."""

    def __init__(self, rank: int, cmd: Sequence[str], env: dict):
        self.rank, self.t0, self.seconds = rank, time.monotonic(), None
        self.proc = subprocess.Popen(list(cmd), env=env, stderr=subprocess.PIPE)
        self.stopped = False  # stopped by the launcher
        self._pump = threading.Thread(target=self._relay, daemon=True)
        self._pump.start()

    def _relay(self) -> None:
        for raw in iter(self.proc.stderr.readline, b""):
            sys.stderr.write(f"[rank {self.rank}] {raw.decode(errors='replace')}")
            sys.stderr.flush()

    def poll(self) -> Optional[int]:
        code = self.proc.poll()
        if code is not None and self.seconds is None:
            self.seconds = time.monotonic() - self.t0
        return code

    def stop(self) -> None:
        if self.poll() is None:
            self.stopped = True
            self.proc.kill()
        self.proc.wait()
        self.poll()
        self._pump.join(timeout=5)

    def report(self) -> str:
        how = describe_exit(self.proc.returncode)
        if self.stopped:
            how = f"stopped by the launcher ({how})"
        return f"rank {self.rank}: {how} after {self.seconds:.1f} s"


def launch(cmd: Sequence[str], nproc: int, timeout_s: float = 3600.0,
           dist_timeout_s: float = 600.0, threads: Optional[int] = None) -> int:
    """Run `cmd` as `nproc` ranks; returns 0, the first failing rank's exit
    status (128 + N for signal N) or 124 when the time limit stopped them.
    A failed run ends with `launch:` lines on standard error: what stopped
    it, and how each rank ended."""
    with tempfile.TemporaryDirectory(prefix="omni_rdzv_") as tmp:
        init_file = os.path.join(tmp, "store")
        ranks = [_Rank(r, cmd, rank_env(r, nproc, init_file, dist_timeout_s, threads))
                 for r in range(nproc)]
        deadline = time.monotonic() + timeout_s
        rc, why = 0, ""
        try:
            while True:
                codes = [r.poll() for r in ranks]
                failed = [r for r, c in zip(ranks, codes) if c not in (None, 0)]
                if failed:
                    rc = shell_code(failed[0].proc.returncode)
                    why = f"rank {failed[0].rank} failed ({describe_exit(codes[failed[0].rank])})"
                    break
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    rc, why = 124, f"the time limit of {timeout_s:g} s passed"
                    break
                time.sleep(0.2)
        finally:
            for r in ranks:
                r.stop()
        if rc:
            lines = [f"launch: exit {rc}: {why}"] + [f"launch: {r.report()}" for r in ranks]
            print("\n".join(lines), file=sys.stderr, flush=True)
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


ERROR_GRACE_S = 5.0  # RankPool.run: how long the other ranks may take to answer after an error


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
        """Every rank's `fn(*args, **kwargs)`. A rank's exception is raised
        here as a RuntimeError once every rank has answered, or
        ERROR_GRACE_S after it when some have not: the others may wait in a
        collective for the rank that raised, and one on card tensors does
        not keep gloo's timeout; the ranks are then killed."""
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
                    now = time.monotonic()
                    if dead or now > deadline or (errors and now > grace):
                        for p in self._procs:  # the ranks left are stuck: killed now
                            p.kill()
                            p.join()
                        if errors:
                            raise RuntimeError("\n".join(errors) + f"\n{name}: the other ranks "
                                               f"had not answered {ERROR_GRACE_S} s later: the "
                                               f"ranks are killed") from None
                        why = f"rank(s) {dead} exited" if dead else "a rank did not answer in time"
                        raise TimeoutError(f"{name}: {why}") from None
            if ok:
                results[rank] = value
            else:
                errors.append(f"rank {rank}: {value}")
                grace = time.monotonic() + ERROR_GRACE_S
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
