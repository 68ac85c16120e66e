"""Milliseconds per SIMPLE iteration: the whole window over all the
iterations completed in it (primal cells)."""


def read(ctx):
    w = ctx["window"]
    if ctx["kind"] != "primal" or not w.get("iters"):
        return None
    return 1e3 * w["seconds"] / w["iters"]
