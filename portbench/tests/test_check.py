"""`correct` comes out false when the timed path is broken underneath, and
for the control (the program's int4 path against the int8 reference);
true for the sound program. The whole run but the look for a card, at
tiny widths on the CPU with the program in float32; the control at the
cell's own size is the `cuda` test at the end."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from portbench import run

from . import tiny

LIMITS = {"beam_gap": 1e-3, "selection_gap": 1e-3}


def _run(seed=17, **kw):
    return run.run_cell(Path("."), "tiny", seed, 1.5, False, device="cpu",
                        loaded=tiny.loaded(tiny.closed_traffic(), LIMITS), dtype=torch.float32,
                        **kw)


def _break_tokens(monkeypatch, change):
    """Replaces the decode body under the serving API by one whose tokens
    `change(tokens)` alters where they are produced."""
    from omni_avsr_tpu_torch import serve

    decode = serve.decode_padded

    def broken(*a, **k):
        out = decode(*a, **k)
        return out._replace(tokens=change(out.tokens.clone()))

    monkeypatch.setattr(serve, "decode_padded", broken)


@pytest.mark.parametrize("seed", [17, 29])
def test_sound_run_is_correct(seed):
    res = _run(seed)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["check"]) == {"beam_gap", "selection_gap", "unanswered"}


def test_an_altered_token_is_caught(monkeypatch):
    def alter(t):
        t[:, 1] = (t[:, 1] + 1) % 293  # a word id, never a special
        return t

    _break_tokens(monkeypatch, alter)
    res = _run()
    assert not res["correct"]
    assert res["check"]["beam_gap"]["value"] > 1e-2


def test_half_the_batch_left_out_is_caught(monkeypatch):
    eos = tiny.config()["vocab_size"] - 6

    def drop(t):
        t[t.shape[0] // 2:] = eos
        return t

    _break_tokens(monkeypatch, drop)
    res = _run()
    assert not res["correct"], res["check"]


def test_the_worst_hypothesis_served_is_caught(monkeypatch):
    """A selection that returns the worst kept hypothesis instead of the
    best: every served token may still lie in its step's top 2K, so only
    the reference's own search tells."""
    from omni_avsr_tpu_torch.decode import decoding

    loop, real = decoding.beam_loop, torch.argmax

    def worst(x, dim=None, **kw):
        if x.is_floating_point() and x.dim() == 2:  # the kept hypotheses' scores
            return torch.argmin(torch.where(x > -1e8, x, torch.full_like(x, float("inf"))),
                                dim=dim, **kw)
        return real(x, dim=dim, **kw)

    def broken(*a, **k):
        torch.argmax = worst
        try:
            return loop(*a, **k)
        finally:
            torch.argmax = real

    monkeypatch.setattr(decoding, "beam_loop", broken)
    res = _run()
    assert not res["correct"], res["check"]
    assert res["check"]["selection_gap"]["value"] > 1e-2


def test_control_int4_fails():
    """The program's own int4 path in the int8 configuration's place."""
    res = _run(quantize="int4")
    assert not res["correct"]
    assert res["check"]["selection_gap"]["value"] > 3 * LIMITS["selection_gap"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,seconds", [("q7b-eval-av-b32", 9.0)])
@pytest.mark.parametrize("seed", [3100000001, 3100000002, 3100000003])
def test_control_at_the_cells_size(cell, seconds, seed):
    """On the card, at the cell's own size and load, with a window that
    finishes as many requests as a run compares: the int4 program fails
    the cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size runs only on the card")
    res = run.run_cell(tiny.PKG.parent, cell, seed, seconds, False, quantize="int4")
    print(json.dumps({"seed": seed, "check": res["check"]}))
    assert not res["correct"], res["check"]
