"""Seconds from the start of the process to the start of the window:
imports, the mesh cache, reading the mesh, building the solver and the
warm-up."""


def read(ctx):
    return ctx["setup_s"]
