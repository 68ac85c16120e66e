"""The window's arithmetic and the reductions of a synthetic trace."""

import pytest

from port_bench import spec
from port_bench.trace import summarize


def _read(name, ctx):
    return spec.metric_reader(name)(ctx)


def test_rates_take_the_whole_window():
    ctx = {"kind": "primal", "window": {"iters": 190, "seconds": 10.097,
                                        "attempted": 19},
           "setup_s": 37.7, "memory_peak_bytes": 2 ** 31, "spans": {}}
    assert _read("primal_iter_ms", ctx) == pytest.approx(1e3 * 10.097 / 190)
    assert _read("peak_mem_gib", ctx) == pytest.approx(2.0)
    assert _read("setup_s", ctx) == 37.7
    ctx["window"] = {"iters": 0, "seconds": 1.0, "attempted": 0}
    assert _read("primal_iter_ms", ctx) is None


def test_whole_chunks_only():
    """The window closes after the chunk that passes ``seconds``, so every
    iteration counted ran inside it."""
    import time

    from port_bench.drive import Cell

    class Solver:
        solve_stats = {}

        class option:
            @staticmethod
            def set(k, v):
                pass

        def run_primal(self, st, x):
            time.sleep(0.02)

            class Info:
                iters, failed = 10, False
            return st, Info()

        def run_function(self, name, st, x):
            return 0.0

    class System:
        def sync(self):
            pass

    c = Cell(System(), {"kind": "primal", "chunk_iters": 10}, {}, None)
    c.solver, c.inputs, c.state = Solver(), {}, {}
    w = c.run_window(0.05)
    assert w["iters"] == 10 * w["attempted"] and w["attempted"] >= 3


def test_idle_share_and_gaps_from_a_synthetic_trace():
    # device: [0, 10) and [5, 20) overlap, then [40, 50); host: op A covers
    # the gap's middle, op B runs inside A
    dev = [("k1", 0.0, 10.0), ("k2", 5.0, 15.0),
           ("void dia_matvec_kernel<float>()", 40.0, 10.0),
           ("Memcpy DtoH", 60.0, 5.0)]
    host = [("A", 0.0, 100.0), ("B", 25.0, 35.0),
            ("cudaStreamSynchronize", 55.0, 66.0)]
    s = summarize(dev, host, 100e-6)
    assert s["busy_s"] == pytest.approx(35e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["kernels"] == 3 and s["syncs"] == 1
    assert s["idle_gaps"][0] == ["B", pytest.approx(20e-6)]
    assert s["dia_seconds"] == {"dia_matvec": [pytest.approx(10e-6)]}
    ctx = {"kind": "primal", "trace": s, "traced_iters": 2}
    assert _read("idle_pct.primal", ctx) == pytest.approx(65.0)
    assert _read("primal.kernels_per_iter", ctx) == 1.5
    assert _read("primal.syncs_per_iter", ctx) == 0.5
