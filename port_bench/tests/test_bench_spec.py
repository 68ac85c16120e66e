"""Cells, configurations, their references, traffic and metrics are found
by name, and a cell defined only by added files loads and runs."""

import json
import os

import pytest

from port_bench import run, spec

ROOT = os.path.dirname(spec.HERE)


def test_every_cell_loads_by_name():
    bench = spec.load_benchmark(ROOT)
    for w in bench["workloads"]:
        cell = spec.load_cell(bench, w["name"])
        assert cell["config"]["name"] == w["config"]
        assert cell["traffic"]["kind"] in spec.KINDS
        assert spec.reference_case(cell["config"]).__name__ == "Case"
        names = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert cell["per_layer"]
        for m in cell["end_to_end"] + cell["per_layer"]:
            assert callable(spec.metric_reader(m["name"]))
        assert all(v is not None for v in cell["limits"].values())


def test_config_files_match_benchmark():
    bench = spec.load_benchmark(ROOT)
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            assert json.load(fh)["name"] == c["name"]


def test_cell_added_as_files_runs(small_bench):
    """A new traffic mix, cell and per-layer metric, each a file added
    under a copy of the folder, run through the unchanged harness."""
    root, base = small_bench
    with open(os.path.join(base, "traffic", "primal_long.json"), "w") as fh:
        json.dump({"kind": "primal", "warmup_iters": 3, "chunk_iters": 4},
                  fh)
    with open(os.path.join(base, "workloads", "sa_primal_long.json"),
              "w") as fh:
        json.dump({"limits": {"start_gap": 0.5, "state_gap": 0.08,
                              "cd_gap": 5e-5}}, fh)
    with open(os.path.join(base, "metrics", "primal.chunks.py"), "w") as fh:
        fh.write("def read(ctx):\n    return float(ctx['window']"
                 "['attempted'])\n")
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["workloads"].append({"name": "sa_primal_long",
                               "config": "naca0012_sa",
                               "traffic": "primal_long", "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "primal_iter_ms":
            m["workloads"].append("sa_primal_long")
    bench["per_layer"].append({"name": "primal.chunks", "unit": "chunks",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "SIMPLE step",
                               "moves": "primal_iter_ms",
                               "workloads": ["sa_primal_long"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    r = run.run("sa_primal_long", 7, 0.0, True, device="cpu", size=(16, 8),
                base=base, root=root)
    assert r["correct"] and r["attempted"] == 1
    assert r["metrics"]["primal.chunks"]["value"] == 1.0
    r = run.run("sa_primal_long", 7, 0.0, False, device="cpu", size=(16, 8),
                base=base, root=root)
    assert set(r["metrics"]) == {"primal_iter_ms", "setup_s"}
    assert list(r)[-1] == "checks"


def _add_cell(root, base, name, config, traffic):
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "primal_iter_ms":
            m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    with open(os.path.join(base, "workloads", name + ".json"), "w") as fh:
        json.dump({"limits": {"start_gap": 0.7, "state_gap": 0.08,
                              "cd_gap": 5e-5}}, fh)


STUB = """from port_bench.reference.plain import Case as _Plain

CALLS = []


class Case(_Plain):
    def step(self, st):
        CALLS.append(self.nc)
        return super().step(st)
"""


def test_configuration_with_its_own_reference_runs(small_bench):
    """A configuration that names a reference module of its own, added as
    files with a primal traffic mix and a cell, runs through the unchanged
    harness and is judged by that module."""
    root, base = small_bench
    with open(os.path.join(base, "configs", "naca0012_sa.json")) as fh:
        config = json.load(fh)
    config.update(name="naca0012_stub", reference="plain_stub")
    with open(os.path.join(base, "configs", "naca0012_stub.json"),
              "w") as fh:
        json.dump(config, fh)
    with open(os.path.join(base, "reference", "plain_stub.py"), "w") as fh:
        fh.write(STUB)
    _add_cell(root, base, "stub_primal", "naca0012_stub", "primal")
    r = run.run("stub_primal", 7, 0.0, False, device="cpu", size=(16, 8),
                base=base, root=root)
    assert r["correct"], r["checks"]
    stub = spec.reference_case(config, base)
    assert stub.__module__ == "port_bench_reference_plain_stub"
    # the judge followed the warm-up's and the last chunk's SIMPLE
    # iterations with it, on 16 x 8 cells
    assert stub.step.__globals__["CALLS"] == [128] * 20


@pytest.mark.parametrize("what", ("kind", "reference"))
def test_unknown_kind_or_missing_reference_names_both(small_bench, what):
    root, base = small_bench
    with open(os.path.join(base, "configs", "naca0012_sa.json")) as fh:
        config = json.load(fh)
    traffic = "primal"
    if what == "kind":
        traffic = "primal_odd"
        with open(os.path.join(base, "traffic", traffic + ".json"),
                  "w") as fh:
            json.dump({"kind": "odd", "warmup_iters": 1, "chunk_iters": 1},
                      fh)
    else:
        config.update(name="naca0012_gone", reference="plain_gone")
        with open(os.path.join(base, "configs", "naca0012_gone.json"),
                  "w") as fh:
            json.dump(config, fh)
    _add_cell(root, base, "odd_cell", config["name"], traffic)
    bench = spec.load_benchmark(root)
    with pytest.raises(ValueError) as err:
        spec.load_cell(bench, "odd_cell", base)
    msg = str(err.value)
    if what == "kind":
        assert "'odd'" in msg and "primal_odd" in msg and "'primal'" in msg
    else:
        assert "plain_gone" in msg and "naca0012_gone" in msg
