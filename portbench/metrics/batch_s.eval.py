"""batch_s.eval: the median over the window's batches of the harness's
span around each `transcribe_many` call (host clock; the call returns
after its ids reach the host)."""

import numpy as np


def read(ctx):
    b = ctx.run.get("batches")
    if not b:
        return None
    return float(np.median([x["t1"] - x["t0"] for x in b]))
