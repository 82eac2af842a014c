"""The training CLIs under several ranks (`omni_avsr_tpu_torch.parallel`):
`train_omni` and `train_llama_avsr` on the synthetic corpus at the tiny
widths, on the CPU with gloo, against the same command in one process.
The ranks run in one group of two for the whole file (the launcher's
`RankPool`: a file-store rendezvous in tmp_path, a 60 s collective
timeout, one torch thread per rank); `parallel/launch.py`'s command-line
launcher starts two ranks of a small program too.

  - `--mesh-tp 2` and `--fsdp true` (dp=2): the first logged train loss
    equals the one-process run's (rtol 1e-4: the CLIs compute in bf16, so
    a row-split product summed over two ranks rounds apart from one sum);
    only rank 0 writes checkpoints, which hold the whole trainable tree:
    after the step every element within two Adam steps (lr 1e-3: a bf16
    grad near zero may take its step with the other sign) of the
    one-process run's, and at most 1% beyond one step; `train_omni`
    resumes from them under the mesh;
  - the parallel flags that need more ranks than run raise the JAX
    package's messages (tests/test_torch_cli.py::test_unported_flags_raise).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as R

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    from omni_avsr_tpu_torch.parallel.launch import RankPool

    p = RankPool(2, str(tmp_path_factory.mktemp("rdzv")), timeout_s=60)
    yield p
    p.close()


def _argv(exp_dir, *extra):
    return ["--synthetic", "4", "--tiny", "true", "--device", "cpu", "--max-epochs", "1",
            "--exp-dir", str(exp_dir), "--auto-test", "false", *extra]


def _first_loss(exp_dir, name: str = "omni") -> float:
    with open(os.path.join(exp_dir, name, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return next(r[k] for r in rows for k in ("train_loss", "loss") if k in r)


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    from omni_avsr_tpu_torch.cli import train_omni

    d = tmp_path_factory.mktemp("one")
    train_omni.main(_argv(d))
    return d


@pytest.mark.parametrize("flags", [["--mesh-tp", "2"], ["--fsdp", "true"]])
def test_train_omni_under_two_ranks(pool, one_process, tmp_path, flags):
    from omni_avsr_tpu_torch.train.checkpoint import list_checkpoints, restore_checkpoint

    written = pool.run(R.cli_case, "train_omni", _argv(tmp_path, *flags), timeout_s=600)
    assert written[1] == [] and len(written[0]) == 2  # the epoch's checkpoint and the average
    np.testing.assert_allclose(_first_loss(tmp_path), _first_loss(one_process), rtol=1e-4)
    got = restore_checkpoint(list_checkpoints(tmp_path / "omni" / "checkpoints")[-1], "cpu")
    want = restore_checkpoint(list_checkpoints(one_process / "omni" / "checkpoints")[-1], "cpu")
    g, w = R.flat(got.trainable), R.flat(want.trainable)
    assert g.keys() == w.keys()
    beyond = total = 0
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=2e-3, rtol=0, err_msg=k)
        beyond += int((np.abs(g[k] - w[k]) > 1e-3).sum())
        total += w[k].size
    assert beyond <= total // 100, (beyond, total)
    # the mesh run resumes from its checkpoint (a second epoch)
    again = pool.run(R.cli_case, "train_omni", _argv(tmp_path, *flags)[:-6] + [
        "--max-epochs", "2", "--exp-dir", str(tmp_path), "--auto-test", "false"],
        timeout_s=600)
    assert again[1] == [] and len(again[0]) == 2
    assert restore_checkpoint(list_checkpoints(tmp_path / "omni" / "checkpoints")[-1],
                              "cpu").step == 2 * got.step


def test_train_llama_avsr_under_two_ranks(pool, tmp_path):
    from omni_avsr_tpu_torch.cli import train_llama_avsr

    argv = ["--synthetic", "6", "--max-epochs", "1", "--modality", "audio", "--device", "cpu",
            "--auto-test", "false"]
    one = tmp_path / "one"
    train_llama_avsr.main(argv + ["--exp-dir", str(one)])
    meshed = tmp_path / "tp"
    written = pool.run(R.cli_case, "train_llama_avsr",
                       argv + ["--exp-dir", str(meshed), "--mesh-tp", "2"], timeout_s=600)
    assert written[1] == [] and written[0]
    name = "llama_avsr" if (one / "llama_avsr").exists() else next(
        p.name for p in one.iterdir() if (p / "metrics.jsonl").exists())
    np.testing.assert_allclose(_first_loss(meshed, name), _first_loss(one, name), rtol=1e-4)


def test_rank_pool_reports_an_error_while_other_ranks_wait(monkeypatch, tmp_path):
    """A rank that raises while another still waits (in a collective on
    card tensors, which gloo's timeout does not end): `RankPool.run` raises
    the rank's error ERROR_GRACE_S later (0.5 s here) and closes the pool,
    rather than waiting for the other rank. A pool of its own: this one is
    closed."""
    import time

    from omni_avsr_tpu_torch.parallel import launch

    monkeypatch.setattr(launch, "ERROR_GRACE_S", 0.5)
    with launch.RankPool(2, str(tmp_path), timeout_s=60) as pool:
        t = time.monotonic()
        with pytest.raises(RuntimeError, match="rank 1 stops here"):
            pool.run(R.raise_or_wait, 120.0)
        assert time.monotonic() - t < 30
        assert not any(p.is_alive() for p in pool._procs)


def test_launcher_starts_ranks(tmp_path):
    """The command-line launcher: two ranks of a program that joins the
    group through `maybe_initialize_distributed` and all-reduces its rank."""
    prog = ("import torch, torch.distributed as dist\n"
            "from omni_avsr_tpu_torch.parallel.distributed import maybe_initialize_distributed\n"
            "assert maybe_initialize_distributed(device='cpu')\n"
            "x = torch.tensor([float(dist.get_rank() + 1)])\n"
            "dist.all_reduce(x)\n"
            "open(f'{sys.argv[1]}/rank{dist.get_rank()}', 'w').write(str(x.item()))\n")
    script = tmp_path / "prog.py"
    script.write_text("import sys\n" + prog)
    run = subprocess.run([sys.executable, "-m", "omni_avsr_tpu_torch.parallel.launch", "--nproc",
                          "2", "--timeout", "120", "--dist-timeout", "60", "--threads", "1", "--",
                          sys.executable, str(script), str(tmp_path)], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ROOT}, timeout=180,
                         capture_output=True, text=True)
    # on failure: the launcher's exit status, its report of how each rank
    # ended, and every rank's standard error (`[rank r]` lines)
    assert run.returncode == 0, f"launcher exit {run.returncode}\n{run.stderr}"
    assert [(tmp_path / f"rank{r}").read_text() for r in range(2)] == ["3.0", "3.0"]


@pytest.mark.parametrize("case, rc, report", [
    ("exit", 3, ["launch: exit 3: rank 1 failed (exit 3)", "rank 0: exit 0", "rank 1: exit 3",
                 "[rank 1] rank 1 fails"]),
    ("abort", 134, ["launch: exit 134: rank 1 failed (killed by signal SIGABRT (6))",
                    "rank 0: stopped by the launcher (killed by signal SIGKILL (9))",
                    "rank 1: killed by signal SIGABRT (6)"]),
    ("hang", 124, ["launch: exit 124: the time limit of 3 s passed",
                   "rank 0: stopped by the launcher", "rank 1: stopped by the launcher"]),
])
def test_launcher_reports_how_ranks_end(tmp_path, case, rc, report):
    """The launcher's exit status says what stopped the run (a rank's own
    code, 128 + N for a rank ended by signal N, 124 for the time limit),
    its last lines how each rank ended, and each rank's standard error
    comes through with a `[rank r]` prefix."""
    script = tmp_path / "prog.py"
    script.write_text(
        "import os, sys, time\n"
        "rank = int(os.environ['RANK'])\n"
        f"case = {case!r}\n"
        "if case == 'exit' and rank == 1:  # after rank 0 has ended\n"
        "    time.sleep(2.0); print('rank 1 fails', file=sys.stderr); sys.exit(3)\n"
        "if case == 'abort' and rank == 1:\n"
        "    time.sleep(0.5); os.abort()\n"
        "if case != 'exit':\n"
        "    time.sleep(60)\n")
    limit = "3" if case == "hang" else "50"
    run = subprocess.run([sys.executable, "-m", "omni_avsr_tpu_torch.parallel.launch", "--nproc",
                          "2", "--timeout", limit, "--", sys.executable, str(script)], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ROOT}, timeout=120,
                         capture_output=True, text=True)
    assert run.returncode == rc, run.stderr
    for line in report:
        assert line in run.stderr, (line, run.stderr)


@pytest.mark.parametrize("environ, devices, local", [
    ({}, 1, 0), ({"LOCAL_RANK": "3"}, 4, 3), ({"SLURM_LOCALID": "1"}, 4, 1), ({}, 4, None)])
def test_num_nodes_counts_ranks(environ, devices, local):
    """`--num-nodes` counts ranks, one per device, where the JAX package's
    counts hosts: with the flags alone on a host of several devices and no
    LOCAL_RANK the start-up raises and names the launchers, rather than
    drive one device of the host; with a local rank, or one device, it
    resolves."""
    from omni_avsr_tpu_torch.parallel.distributed import resolve_rendezvous

    args = (2, "10.0.0.1:1234", 1)
    if local is None:
        with pytest.raises(ValueError, match="one per device.*torchrun"):
            resolve_rendezvous(*args, environ=environ, local_devices=devices)
    else:
        assert resolve_rendezvous(*args, environ=environ, local_devices=devices) == (
            "tcp://10.0.0.1:1234", 2, 1, local)
