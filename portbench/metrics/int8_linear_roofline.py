"""int8_linear_roofline: the least time of every int8 weight-only
linear the window's decode calls need (`work/omni.py::bound_s`: bytes at
3.35 TB/s or FLOPs at 989 TFLOP/s, whichever is larger, per product) over
the device time of the kernels `kernels/int8_linear.json` maps, in %."""

from portbench.work.omni import bound_s


def read(ctx):
    if ctx.trace is None or not ctx.units:
        return None
    bound = sum(bound_s(*mkn) for u in ctx.units for mkn in u["int8"])
    spent = ctx.trace.layer_s("int8_linear")
    if bound > 0 and spent <= 0:
        raise RuntimeError("int8 linears have work but no kernel of kernels/int8_linear.json ran")
    return 100.0 * bound / spent if spent > 0 else None
