"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json: the cell's entry
names its configuration (a file of sizes under `configs/`) and its traffic
mix (`traffic/<mix>.json`, whose `kind` is the generator
`traffic/<kind>.py`); `workloads/<cell>.json` holds the cell's check; each
metric is read by `metrics/<metric>.py`, or by `metrics/<quantity>.py`
for a metric `<quantity>.<cells>` that one reader serves in several
cells. Set-up builds the system under
test (`systems/<system>.py`, named by the configuration) on weights drawn
from the seed, makes the traffic's inputs and warms each shape the
traffic sends; then the window runs for `--seconds` (the traffic may end it on a
whole pass over its pool), under a device trace
with `--trace 1`; then, with the program's state freed, what the timed
path produced is compared with the plain reference (the system module's
`check`). The last line of standard output is the result; the compared
numbers, each beside its limit, end standard error.

Exits 2, printing no result, without as many CUDA devices as the cell
asks for; exits 1 when anything fails, or when a JAX module or the JAX
package was loaded by the time the window closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict  # noqa: E402

PKG = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "omni_avsr_tpu"}


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def load_cell(root: Path, name: str):
    """(bench, cell entry, configuration, traffic mix, cell check) by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    centry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / centry["file"]).read_text())
    traffic = json.loads((PKG / "traffic" / f"{cell['traffic']}.json").read_text())
    check = json.loads((PKG / "workloads" / f"{name}.json").read_text())
    return bench, cell, cfg, traffic, check


def metric_reader(name: str):
    path = PKG / "metrics" / f"{name}.py"
    if not path.exists():
        path = PKG / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool):
    """The metric entries a run of `cell` reports: its end-to-end metrics,
    or with a trace its per-layer ones."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def use_checkout_caches(root: Path) -> None:
    """Kernel and compiler caches at fixed paths inside the checkout."""
    build = root / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton_cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool, device="cuda",
             fault=None, loaded=None, dtype=None, **system_kw) -> Dict:
    """One run of a cell -> the result dict (without printing it).
    `fault(system)` breaks the timed path underneath (the check's own
    test); `loaded` is `load_cell`'s tuple, given instead of `root`;
    `dtype` the program's compute dtype (the tests' float32);
    `system_kw` go to the system (the serving control's `quantize`)."""
    import torch

    from .trace import DeviceTrace
    from .work.omni import OmniWork

    bench, cell, cfg, traffic, cellcheck = loaded or load_cell(root, name)
    gen = importlib.import_module(f"portbench.traffic.{traffic['kind']}")
    system_mod = importlib.import_module(f"portbench.systems.{cfg['system']}")
    on_card = torch.device(device).type == "cuda"

    if dtype is not None:
        system_kw["dtype"] = dtype
    system = system_mod.System(cfg, seed, device, **system_kw)
    build_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if fault is not None:
        fault(system)
    state = gen.prepare(traffic, seed, seconds, device, cfg=cfg)
    gen.warmup(system, state)
    system.forget()
    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's scans, as a server does once loaded
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_PROCESS
    tracer = DeviceTrace() if trace else contextlib.nullcontext()
    with tracer:
        run = gen.window(system, state, seconds)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    ctx = SimpleNamespace(setup_s=setup_s, peak_bytes=peak, run=run,
                          units=system.units(run, OmniWork(cfg)), trace=tracer if trace else None)
    metrics = {}
    for m in cell_metrics(bench, name, trace):
        v = metric_reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    breakdown = tracer.breakdown(system.spans(run)) if trace else None
    record = system.record(run)
    system.close()
    del system, state, ctx

    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"loaded by the time the window closed: {', '.join(bad)}")

    numbers = system_mod.check(cfg, seed, device, record, cellcheck, dtype)
    limits = cellcheck["limits"]
    correct = all(not math.isnan(v) and v <= limits[k] for k, v in numbers.items())
    result = {"correct": correct, "attempted": run["attempted"], "failed": int(record["failed"]),
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        result["device"].update(busy_s=tracer.busy_s(), window_s=tracer.window_s)
        result["breakdown"] = breakdown
    result["info"] = {"build_peak_bytes": int(build_peak), **record.get("info", {})}
    result["check"] = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return result


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    args = ap.parse_args(argv)
    root = Path.cwd()
    use_checkout_caches(root)
    cell = load_cell(root, args.workload)[1]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace))
    result["info"]["card"] = power_limit()
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded: {', '.join(bad)}", file=sys.stderr)
        return 1
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except SystemExit:
        raise
    except BaseException as e:  # no result line: the traceback and a non-zero exit
        import traceback

        traceback.print_exc()
        print(f"portbench: {type(e).__name__}: {e}", file=sys.stderr)
        code = 1
    sys.exit(code)
