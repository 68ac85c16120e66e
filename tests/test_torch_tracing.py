"""The span recorder of dafoam_tpu_torch.utils.timing on the SIMPLE step.

On the 16x8 Spalart-Allmaras channel in the dense-DIA layout (the
banded path of the airfoil case), 10 SIMPLE iterations with the inner
Krylov solves exiting on their tolerances:

- the recorder changes nothing the solver computes: the state after the
  chunk is bitwise the same with it on and off;
- off, a span reads no clock and enters no ``record_function``, and
  nothing is recorded;
- on, every Krylov solve lies in a phase of the SIMPLE step, there is one
  ``krylov.solve`` span per logged solve and one ``krylov.rn`` read per
  inner iteration, and the set-up records its own spans;
- with a block of several iterations forced on the device PCG of the p
  solves, one ``krylov.rn`` read per block, and the same state;
- under a CPU ``torch.profiler`` session the phases appear as host
  events, and every host read of a number (``aten::_local_scalar_dense``)
  lies inside a ``sync.*`` read span;
- ``Timer.phase`` records a span, and ``trace()``'s Chrome export holds
  the spans opened inside it.
"""

import pytest
import torch

from dafoam_tpu_torch.mesh import box_hex_mesh
from dafoam_tpu_torch.solvers import make_solver
from dafoam_tpu_torch.utils import timing

torch.set_num_threads(1)
NU = 1e-4
ITERS = 10
PHASES = ("simple.momentum", "simple.pressure", "simple.turbulence")


def channel_options():
    zero = [0.0, 0.0, 0.0]
    zg = {"type": "zeroGradient"}

    def fv(v):
        return {"type": "fixedValue", "value": v}

    return {"solverName": "DASimpleFoam",
            "turbulenceModel": "SpalartAllmaras",
            "transportProperties": {"nu": NU}, "meshFaceLayout": "diaDense",
            "boundaryConditions": {
                "U": {"xmin": fv([1.0, 0.0, 0.0]), "xmax": zg,
                      "ymin": fv(zero), "ymax": fv(zero)},
                "p": {"xmin": zg, "xmax": fv(0.0), "ymin": zg, "ymax": zg},
                "nuTilda": {"xmin": fv(3 * NU), "xmax": zg,
                            "ymin": fv(0.0), "ymax": fv(0.0)}},
            "initialFields": {"U": [1.0, 0.0, 0.0], "p": 0.0,
                              "nuTilda": 3 * NU},
            "primalMinResTol": 0.0, "primalMinIters": ITERS,
            "primalMaxIters": ITERS,
            "primalLinearSolver": {"pMaxIters": 50, "pRelTol": 0.05,
                                   "uMaxIters": 20, "uRelTol": 0.1,
                                   "turbMaxIters": 20, "turbRelTol": 0.1},
            "relaxationFactors": {"fields": {"p": 0.2},
                                  "equations": {"U": 0.5, "nuTilda": 0.5}}}


@pytest.fixture(scope="module")
def case():
    kinds = {"zmin": "empty", "zmax": "empty", "ymin": "wall",
             "ymax": "wall"}
    pts, topo = box_hex_mesh(16, 8, 1, (1.0, 0.1, 0.01), kinds=kinds)
    with timing.recording() as rec:
        solver = make_solver(channel_options(), topo, pts, device="cpu",
                             dtype=torch.float64)
        inputs = solver.make_inputs()
        st0 = solver.init_state()
    return solver, inputs, st0, rec


def chunk(case):
    solver, inputs, st0, _ = case
    solver.solve_stats.clear()
    st, info = solver.run_primal(st0, inputs)
    assert info.iters == ITERS and not info.failed
    return st, solver.solve_stats


def test_recorder_leaves_the_state_bitwise_equal(case):
    off, _ = chunk(case)
    with timing.recording() as rec:
        on, _ = chunk(case)
    assert rec.spans
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k


def test_nothing_recorded_when_off(case, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a span read the clock or entered the profiler")

    monkeypatch.setattr(timing, "_clock", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert timing._REC is None
    chunk(case)
    assert timing.span("simple.iteration") is timing.span("krylov.solve")
    assert timing._REC is None


def test_spans_nest_and_count_the_solves(case):
    with timing.recording() as rec:
        _, stats = chunk(case)
    spans = rec.spans
    assert all(s[3] is not None for s in spans)
    agg = rec.aggregate()
    assert agg["simple.solve_primal"]["count"] == 1
    assert agg["simple.iteration"]["count"] == ITERS
    for name in PHASES:
        assert agg[name]["count"] == ITERS
    for name, parent, _, _ in spans:
        if name == "krylov.solve":
            assert spans[parent][0] in PHASES
        if name in PHASES:
            assert spans[parent][0] == "simple.iteration"
    assert agg["krylov.solve"]["count"] == sum(v[0] for v in stats.values())
    inner = sum(v[1] for v in stats.values())
    assert agg["sync.krylov.rn"]["count"] == inner
    assert agg["sync.simple.residual"]["count"] == ITERS
    assert agg["sync.simple.valid"]["count"] == ITERS + 1
    it = agg["simple.iteration"]
    assert 0.0 < it["self_seconds"] < it["seconds"]


def test_one_rn_read_per_block_of_the_device_pcg(case, monkeypatch):
    from dafoam_tpu_torch.linalg import krylov
    one, _ = chunk(case)
    block = 4
    monkeypatch.setitem(krylov.PCG_BLOCK, "cpu", block)
    krylov.reset_counts()
    with timing.recording() as rec:
        st, stats = chunk(case)
    for k in one:   # the iterations after an exit change nothing
        assert torch.equal(one[k], st[k]), k
    n_p, p_iters = stats["p"]
    counts = krylov.COUNTS
    assert counts["pcg_solves"] == n_p and counts["cg_solves"] == 0
    assert counts["pcg_iters"] == p_iters
    blocks, rest = divmod(p_iters + counts["pcg_masked_iters"], block)
    assert rest == 0 and n_p <= blocks < p_iters
    others = sum(v[1] for name, v in stats.items() if name != "p")
    assert rec.aggregate()["sync.krylov.rn"]["count"] == others + blocks


def test_setup_spans(case):
    agg = case[3].aggregate()
    for name in ("setup.dia_layout", "setup.wall_distance"):
        assert agg[name]["count"] == 1
    assert agg["setup.geometry"]["count"] == 2


def test_spans_in_the_profiler_and_reads_inside_sync_spans(case,
                                                           monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    # the read spans stay out of the profiler; wrap them in one here to
    # see them on the profiler's clock
    def visible(fn):
        def call(site, *args):
            with torch.profiler.record_function("sync." + site):
                return fn(site, *args)
        return call

    monkeypatch.setattr(timing, "host_read", visible(timing.host_read))
    monkeypatch.setattr(timing, "host_copy", visible(timing.host_copy))
    with timing.recording():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            chunk(case)
    ev = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
          for e in prof.profiler.kineto_results.events()]
    names = {e[0] for e in ev}
    for name in PHASES + ("simple.iteration", "krylov.solve"):
        assert name in names
    reads = [e for e in ev if e[0].startswith("sync.")]
    scalar = [e for e in ev if e[0] == "aten::_local_scalar_dense"]
    assert scalar
    outside = [e for e in scalar
               if not any(r[1] <= e[1] and e[2] <= r[2] for r in reads)]
    assert outside == []


def test_timer_phase_records_a_span():
    t = timing.Timer()
    with timing.recording() as rec:
        with t.phase("adjoint"):
            with timing.span("inner"):
                pass
    agg = rec.aggregate()
    assert agg["adjoint"]["count"] == 1 and agg["inner"]["count"] == 1
    assert rec.spans[1][1] == 0
    assert list(t.report()) == ["adjoint"]


def test_trace_exports_spans(tmp_path):
    import json

    with timing.trace(str(tmp_path / "tr")) as logdir:
        with timing.span("simple.iteration"):
            with timing.span("krylov.solve"):
                torch.ones(4).sum()
    assert timing._REC is None
    with open(f"{logdir}/trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"simple.iteration", "krylov.solve"} <= names
