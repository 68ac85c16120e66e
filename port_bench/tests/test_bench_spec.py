"""Cells, configurations, traffic and metrics are found by name, and a cell
defined only by added files loads and runs."""

import json
import os

from port_bench import run, spec

ROOT = os.path.dirname(spec.HERE)


def test_every_cell_loads_by_name():
    bench = spec.load_benchmark(ROOT)
    for w in bench["workloads"]:
        cell = spec.load_cell(bench, w["name"])
        assert cell["config"]["name"] == w["config"]
        assert cell["traffic"]["kind"] == "primal"
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
