"""Share, in %, of the traced stage's wall time in which no operation ran
on the device (profiler), primal cells."""


def read(ctx):
    s = ctx.get("trace")
    if ctx["kind"] != "primal" or not s or s["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
