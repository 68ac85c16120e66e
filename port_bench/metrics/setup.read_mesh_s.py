"""Seconds in read_polymesh of the case (span of the benchmark)."""


def read(ctx):
    return ctx["spans"].get("setup.read_mesh")
