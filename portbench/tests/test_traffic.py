"""The traffic generators: deterministic by seed, every seed the same work."""

from __future__ import annotations

import json

import numpy as np

from portbench import media
from portbench.traffic import closed_batches

from .tiny import PKG


def _mix(name):
    return json.loads((PKG / "traffic" / f"{name}.json").read_text())


def _sizes(state):
    return [(r.modality, r.beams, r.frames) for r in state]


def test_closed_batches_by_seed():
    """One seed makes the same pool; another the same batches (each the
    same multiset of lengths) in another order."""
    p = dict(_mix("eval-av-b32"), batch_size=4, pool_batches=3)
    a = closed_batches.prepare(p, 11, 10.0, "cpu")
    b = closed_batches.prepare(p, 11, 10.0, "cpu")
    c = closed_batches.prepare(p, 12, 10.0, "cpu")
    flat = lambda s: [r for batch in s["pool"] for r in batch]  # noqa: E731
    assert _sizes(flat(a)) == _sizes(flat(b))
    for x, y in zip(flat(a), flat(b)):
        assert np.array_equal(x.item["video"], y.item["video"])
        assert np.array_equal(x.item["audio"], y.item["audio"])
    batches = lambda s: sorted(sorted(_sizes(batch)) for batch in s["pool"])  # noqa: E731
    assert batches(a) == batches(c)  # the same work
    assert _sizes(flat(a)) != _sizes(flat(c))  # in another order
    r = flat(a)[0]
    assert r.item["video"].shape == (r.frames, 96, 96, 3) and r.item["video"].dtype == np.uint8
    assert r.item["audio"].shape == (r.frames * 640,) and r.item["audio"].dtype == np.float32
    assert all(25 <= x.frames <= 400 and x.beams == 15 for x in flat(a))


def test_lengths_keep_the_sourced_mean():
    x = media.lengths(np.random.default_rng(0),
                      {"dist": "lognormal", "mean_s": 2.725, "sigma": 0.5, "lo": 1, "hi": 10 ** 6},
                      200000)
    assert abs(x.mean() / 25.0 - 2.725) < 0.01


class _Clock:
    """A system each of whose calls takes one second of a fake clock."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t

    def tick(self, *a, **k):
        self.t += 1.0
        return 1.0

    def tag(self, *a):
        pass


def test_window_ends_on_a_whole_pass(monkeypatch):
    """The window runs on past `seconds` to the end of a pass over the
    pool, and times all of it."""
    import portbench.traffic.closed_batches as cb

    clk = _Clock()
    clk.serve = clk.tick
    monkeypatch.setattr(cb, "time", clk)
    pool = [[media.Req(i, "audio", 1, 25, {})] for i in range(3)]
    run = cb.window(clk, {"pool": pool, "p": {"modality": "audio", "beams": 1}}, 4.5)
    assert len(run["batches"]) == 6 and run["t_end"] - run["t_start"] == 6.0
