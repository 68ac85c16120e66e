"""Share, in %, of the least time of the traced K1/K2 launches in their
device time (roofline.py counts their bytes and flops), primal cells."""

from port_bench.roofline import roofline_pct

KINDS = ("dia_matvec", "dia_matvec_multi")


def read(ctx):
    s = ctx.get("trace")
    if ctx["kind"] != "primal" or not s:
        return None
    calls = {k: ctx["dia_calls"].get(k, []) for k in KINDS}
    return roofline_pct(calls, {k: s["dia_seconds"].get(k, []) for k in KINDS})
