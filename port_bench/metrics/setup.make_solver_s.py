"""Seconds in make_solver, make_inputs and init_state (span of the
benchmark)."""


def read(ctx):
    return ctx["spans"].get("setup.make_solver")
