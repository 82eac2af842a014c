"""mfu.<cells>: the model FLOPs of the window's work units (`work/omni.py`:
a served batch's decode call at valid lengths, every beam row of every
decode step) over the traced window times the H100's dense bf16 peak, in
%."""

from portbench.work.omni import PEAK_BF16_FLOPS


def read(ctx):
    if ctx.trace is None or not ctx.units:
        return None
    return 100.0 * sum(u["flops"] for u in ctx.units) / (ctx.trace.window_s * PEAK_BF16_FLOPS)
