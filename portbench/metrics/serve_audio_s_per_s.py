"""serve_audio_s_per_s: seconds of input audio transcribed over the
window, from its start to the end of its last batch, every batch in."""


def read(ctx):
    run = ctx.run
    if "batches" not in run or not run["requests"]:
        return None
    return sum(r.audio_s for r in run["requests"]) / (run["t_end"] - run["t_start"])
