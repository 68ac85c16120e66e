"""The control of ``correct``: the plain reference in float32 with its
state rounded to bfloat16 after every SIMPLE iteration, put in the
program's place, which the check has to find not correct.

    python3 -m port_bench.control --workload <cell> --seeds 1 2 3

For each seed: the cell's set-up and one chunk of the window's own size,
both made by the control (``system.Control``), then the same judge as a
benchmark run. Prints one JSON line per seed with each number beside its
limit. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def control_run(workload, seed, *, device="cuda", size=None, base=None,
                root=None):
    """{check: (value, limit)} and notes of the control on one seed."""
    from port_bench import case as casemod
    from port_bench import meshgen, spec
    from port_bench.drive import Cell, Spans
    from port_bench.reference.judge import judge
    from port_bench.run import HERE, ROOT
    from port_bench.system import Control

    base = base or HERE
    cell = spec.load_cell(spec.load_benchmark(root or ROOT), workload, base)
    opts, _ = casemod.options(cell["config"], cell["traffic"], seed)
    mesh = meshgen.omesh(**casemod.mesh_spec(cell["config"], size))
    case = {"mesh": mesh}
    ctl = Control(device)
    c = Cell(ctl, cell["traffic"], opts, Spans(ctl.sync)).setup(case)
    c.run_window(0.0)
    out = c.outputs()
    del c
    return judge(case, opts, out, cell["limits"], device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        t0 = time.perf_counter()
        checks, notes = control_run(args.workload, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "checks": {k: {"value": v, "limit": lim}
                                     for k, (v, lim) in checks.items()},
                          "notes": notes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
