"""beam_attn_roofline: the bytes of prefix and generated keys and
values (and the queries and outputs) every decode step needs, at 3.35
TB/s, over the device time of the kernels `kernels/beam_attn.json` maps,
in %."""

from portbench.work.omni import PEAK_HBM_BYTES


def read(ctx):
    if ctx.trace is None or not ctx.units:
        return None
    need = sum(u["beam_attn_bytes"] for u in ctx.units) / PEAK_HBM_BYTES
    spent = ctx.trace.layer_s("beam_attn")
    if need > 0 and spent <= 0:
        raise RuntimeError("decode steps ran but no kernel of kernels/beam_attn.json did")
    return 100.0 * need / spent if spent > 0 else None
