"""The check that decides ``correct``, on the CPU at small sizes: the plain
reference reproduces the program's SIMPLE iteration where both run in
float64; a sound run passes, the control (the reference in float32 with
its state rounded to bfloat16) fails, and so does a run whose timed path
is broken underneath: a step that returns its state unchanged, half of
the cells left out of the update, an answer altered where it is produced.
The harness's look for a chip is skipped (``run.run`` on the CPU)."""

import copy

import pytest
import torch

from port_bench import case as casemod
from port_bench import meshgen, run, spec
from port_bench.control import control_run
from port_bench.reference.judge import face_index, follow
from port_bench.reference.plain import Case

CELLS = ("sa_primal_1m",)
SIZE = (16, 8)


def _run(bench, cell, seed=5):
    root, base = bench
    return run.run(cell, seed, 0.0, False, device="cpu", size=SIZE,
                   base=base, root=root)


def _failing(r):
    return {k: v["value"] for k, v in r["checks"].items()
            if not v["value"] <= v["limit"]}


@pytest.mark.parametrize("layout", ("canonical", "diaDense"))
def test_reference_reproduces_the_program_in_float64(tmp_path, layout):
    """Both sides in float64 from the same states: every field of five
    SIMPLE iterations, and CD, agree to rounding."""
    from dafoam_tpu_torch.mesh.polymesh import read_polymesh
    from dafoam_tpu_torch.solvers import make_solver

    from port_bench.drive import face_layout, primal_chunk
    cell = spec.load_cell(spec.load_benchmark(run.ROOT), "sa_primal_1m")
    opts, _ = casemod.options(cell["config"], cell["traffic"], 11)
    opts = copy.deepcopy(opts)
    opts["meshFaceLayout"] = layout
    mspec = casemod.mesh_spec(cell["config"], (24, 12))
    mesh = meshgen.omesh(**mspec)
    case_dir, _ = meshgen.cached_case(str(tmp_path), mspec, mesh)
    pts, topo = read_polymesh(case_dir)
    prog = make_solver(opts, topo, pts, device="cpu", dtype=torch.float64)
    ref = Case(mesh, opts, device="cpu")
    idx = face_index(face_layout(prog.topo), mesh)
    x = prog.make_inputs()
    st, _ = primal_chunk(prog, prog.init_state(), x, 3)
    end, _ = primal_chunk(prog, st, x, 5)
    for start, stop, n in ((None, st, 3), (st, end, 5)):
        gaps = {k: d / c for k, (d, c, _) in
                follow(ref, idx, start, stop, n).items()}
        assert max(gaps.values()) < 1e-9, gaps
    cfg = opts["function"]["CD"]
    from port_bench.reference.judge import _to_ref
    cd_r = ref.force(_to_ref(end, ref, idx), cfg["patches"],
                     cfg["direction"])
    cd_p = float(prog.run_function("CD", end, x))
    assert abs(cd_p - cd_r) <= 1e-12 * abs(cd_r)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(small_bench, cell):
    r = _run(small_bench, cell)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(small_bench, cell):
    root, base = small_bench
    checks, _ = control_run(cell, 5, device="cpu", size=SIZE, base=base,
                            root=root)
    assert any(not v <= lim for v, lim in checks.values()), checks


def _half(new, old):
    out = {}
    for k, v in new.items():
        n = v.shape[0] // 2
        out[k] = torch.cat([v[:n], old[k][n:]])
    return out


def _alter(state):
    out = dict(state)
    u = state["U"].clone()
    u[u.shape[0] // 3] += 0.5 * float(u.abs().max())
    out["U"] = u
    return out


PRIMAL_FAULTS = {
    "unchanged": lambda new, old: old,
    "half": _half,
    "altered": lambda new, old: _alter(new),
}


@pytest.mark.parametrize("fault", sorted(PRIMAL_FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_primal_is_not_correct(small_bench, monkeypatch, cell,
                                      fault):
    from dafoam_tpu_torch.solvers.simple import DASimpleFoam
    f = PRIMAL_FAULTS[fault]
    step = DASimpleFoam.primal_step

    def bad_step(self, state, *a, **k):
        new, res = step(self, state, *a, **k)
        return f(new, state), res

    monkeypatch.setattr(DASimpleFoam, "primal_step", bad_step)
    r = _run(small_bench, cell)
    assert not r["correct"] and _failing(r), r["checks"]


# the parent commit's checks and notes of this run (one torch thread), to
# the last digit: the dispatch on the traffic kind and the configuration's
# reference leaves the primal cell's comparison as it was
PARENT_PRIMAL = {
    "checks": {"start_gap": {"value": 0.00028888428655542906, "limit": 0.7},
               "state_gap": {"value": 5.824820126011658e-06, "limit": 0.08},
               "cd_gap": {"value": 4.343476152479964e-08, "limit": 5e-05}},
    "notes": {"start_gap_by_field": {"U": 1.347259872521465e-05,
                                     "p": 6.018333304044625e-06,
                                     "nuTilda": 1.1249215261853032e-05,
                                     "phi": 0.00028888428655542906},
              "state_gap_by_field": {"U": 9.128643357899497e-07,
                                     "p": 1.8020522184741055e-06,
                                     "nuTilda": 5.824820126011658e-06,
                                     "phi": 1.3861529715766806e-07},
              "cd": 0.007562083192169666,
              "cd_reference": 0.007562083520626961}}


def test_primal_checks_are_the_parents(small_bench):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = _run(small_bench, "sa_primal_1m")
    finally:
        torch.set_num_threads(threads)
    assert {"checks": r["checks"], "notes": r["notes"]} == PARENT_PRIMAL
