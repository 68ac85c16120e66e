"""Host waits on the device (cudaStreamSynchronize and the like) per
iteration in the traced stage (profiler), primal cells."""


def read(ctx):
    s = ctx.get("trace")
    if ctx["kind"] != "primal" or not s or not ctx.get("traced_iters"):
        return None
    return s["syncs"] / ctx["traced_iters"]
