"""peak_device_gib: `torch.cuda.max_memory_allocated()` over the measured
window (peak statistics reset once set-up ends), in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30
