"""setup_s: seconds from the process's start to the first timed request
(imports, weights drawn from the seed, the serving tree built, warm-up)."""


def read(ctx):
    return ctx.setup_s
