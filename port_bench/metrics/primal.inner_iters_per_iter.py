"""Krylov iterations of the inner solves (all fields) per SIMPLE
iteration over the window, from the solver's solve_stats (primal cells)."""


def read(ctx):
    w = ctx["window"]
    if ctx["kind"] != "primal" or not w.get("iters") or \
            not w.get("solve_stats"):
        return None
    return sum(v[1] for v in w["solve_stats"].values()) / w["iters"]
