"""Finding a cell's parts by name.

``BENCHMARK.json`` (at the root of the checkout) names each cell's
configuration and traffic; the files are

- ``configs/<config>.json``: the configuration (options, mesh, inflow);
- ``traffic/<traffic>.json``: the traffic mix (kind of loop and its sizes);
- ``workloads/<cell>.json``: the cell's limits for ``correct``;
- ``metrics/<metric>.py``: one reader per metric, ``read(ctx)``.

A later change adds a configuration, a mix, a cell or a metric by adding
files; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def _json(path):
    with open(path) as fh:
        return json.load(fh)


def load_benchmark(root):
    return _json(os.path.join(root, "BENCHMARK.json"))


def load_cell(bench, name, base=HERE):
    """Everything one run of cell ``name`` needs, as a dict: the cell entry,
    its configuration, traffic and limits, and the names of the metrics it
    reports (end-to-end with ``--trace 0``, per-layer with ``--trace 1``)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    cell = cells[name]
    config = _json(os.path.join(base, "configs", cell["config"] + ".json"))
    traffic = _json(os.path.join(base, "traffic", cell["traffic"] + ".json"))
    limits = _json(os.path.join(base, "workloads", name + ".json"))

    def reported(group):
        return [m for m in bench[group]
                if name in m.get("workloads", [name])]

    return {"cell": cell, "config": config, "traffic": traffic,
            "limits": limits["limits"], "end_to_end": reported("end_to_end"),
            "per_layer": reported("per_layer")}


def metric_reader(metric, base=HERE):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = os.path.join(base, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
