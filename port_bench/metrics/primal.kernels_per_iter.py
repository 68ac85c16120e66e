"""Device kernels per iteration in the traced stage (profiler), primal
cells."""


def read(ctx):
    s = ctx.get("trace")
    if ctx["kind"] != "primal" or not s or not s["kernels"] \
            or not ctx.get("traced_iters"):
        return None
    return s["kernels"] / ctx["traced_iters"]
