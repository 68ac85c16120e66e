"""Finding a cell's parts by name.

``BENCHMARK.json`` (at the root of the checkout) names each cell's
configuration and traffic; the files are

- ``configs/<config>.json``: the configuration (options, mesh, inflow,
  and ``reference``, the module of its plain reference, ``plain`` when
  absent);
- ``reference/<reference>.py``: a plain reference, with ``Case``;
- ``traffic/<traffic>.json``: the traffic mix (its ``kind`` of loop and
  its sizes);
- ``workloads/<cell>.json``: the cell's limits for ``correct``;
- ``metrics/<metric>.py``: one reader per metric, ``read(ctx)``.

A later change adds a configuration, its reference, a mix, a cell or a
metric by adding files; nothing here names one. A new kind of loop is
the one thing that takes an entry in ``KINDS``.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))

# a traffic kind: the loop of ``drive.py`` that drives it and the function
# of ``reference/judge.py`` that judges what the loop hands over
KINDS = {"primal": ("Cell", "judge_primal")}
DEFAULT_REFERENCE = "plain"


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
    kind = traffic.get("kind")
    if kind not in KINDS:
        raise ValueError(f"traffic {cell['traffic']!r} of workload {name!r} "
                         f"has kind {kind!r}; the harness has a loop for "
                         f"{sorted(KINDS)}")
    ref = reference_path(config, base)
    if not os.path.isfile(ref):
        raise ValueError(f"configuration {cell['config']!r} of workload "
                         f"{name!r} names the reference module "
                         f"{config.get('reference', DEFAULT_REFERENCE)!r}, "
                         f"and there is no {ref}")

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


def loop_and_judge(kind):
    """(the loop class of ``drive.py``, the judge of ``reference/judge.py``)
    of a traffic kind."""
    from port_bench import drive
    from port_bench.reference import judge
    loop, jd = KINDS[kind]
    return getattr(drive, loop), getattr(judge, jd)


def reference_path(config, base=HERE):
    return os.path.join(base, "reference", config.get(
        "reference", DEFAULT_REFERENCE) + ".py")


_REFERENCES = {}


def reference_case(config, base=HERE):
    """The ``Case`` class of the configuration's plain reference, the
    module ``reference/<reference>.py`` (``plain`` when the configuration
    names none), loaded from its file once per process."""
    path = reference_path(config, base)
    if path not in _REFERENCES:
        name = os.path.splitext(os.path.basename(path))[0]
        spec = importlib.util.spec_from_file_location(
            "port_bench_reference_" + name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _REFERENCES[path] = mod.Case
    return _REFERENCES[path]
