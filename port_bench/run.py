"""Run one cell of the benchmark once.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with an NVIDIA GPU. The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, the numbers that decided ``correct``
beside their limits (also the last lines of standard error). Without a
CUDA device, or with fewer than the cell asks for, it prints no result and
exits with code 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "dafoam_tpu")


def _cache_env():
    """Build and kernel caches at fixed paths inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_jit")):
        os.environ[var] = os.path.join(CACHE, sub)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``dafoam_tpu_torch`` is not ``dafoam_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def say(msg):
    print(msg, file=sys.stderr, flush=True)


def _card():
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
            else ""
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return ""


def run(workload, seed, seconds, trace, *, device="cuda", size=None,
        base=HERE, root=ROOT):
    """One run of ``workload``: set-up, window, optional traced stage and
    the check. Returns the result dict (without printing). ``size``
    (n_wrap, n_radial) and ``device`` "cpu" serve the CPU tests."""
    import torch

    from port_bench import case as casemod
    from port_bench import meshgen, spec
    from port_bench.drive import Cell, Spans
    from port_bench.reference.judge import judge
    from port_bench.system import Program
    from port_bench.trace import Traced

    cell = spec.load_cell(spec.load_benchmark(root), workload, base)
    config, traffic = cell["config"], cell["traffic"]
    opts, aoa = casemod.options(config, traffic, seed)
    mspec = casemod.mesh_spec(config, size)
    on_cuda = torch.device(device).type == "cuda"
    system = Program(device)
    spans = Spans(system.sync)

    key = meshgen.mesh_key(mspec)
    with spans.span("setup.mesh_cache"):
        mesh = None
        if not os.path.isdir(os.path.join(CACHE, "mesh", key)):
            mesh = meshgen.omesh(**mspec)
        case_dir, wrote = meshgen.cached_case(os.path.join(CACHE, "mesh"),
                                              mspec, mesh)
    case = {"dir": case_dir, "mesh": mesh, "key": key}
    c = Cell(system, traffic, opts, spans).setup(case)
    system.sync()
    setup_s = time.perf_counter() - T_START
    say(f"[setup] {workload} seed {seed}: aoa {aoa:.6f} deg, "
        f"{c.solver.topo.n_cells} cells, setup {setup_s:.3f} s "
        f"(mesh written {wrote:.3f} s), spans {spans.seconds}")

    tail = None
    if trace:
        tail = Traced(sys.modules["dafoam_tpu_torch.ops.dia_kernels"])
    w = c.run_window(seconds, tail)
    say(f"[window] {w['attempted']} chunks, {w['iters']} iterations "
        f"in {w['seconds']:.3f} s, failed {w['failed']}")
    peak = int(torch.cuda.max_memory_allocated()) if on_cuda else 0
    ctx = {"kind": traffic["kind"], "setup_s": setup_s,
           "spans": dict(spans.seconds),
           "window": w, "memory_peak_bytes": peak, "trace": None}
    if trace:
        ctx.update(trace=tail.summary, traced_iters=tail.iters,
                   dia_calls=tail.dia.calls)
    out = c.outputs()
    del c, tail
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    if case["mesh"] is None:
        case["mesh"] = meshgen.omesh(**mspec)
    checks, notes = judge(case, opts, out, cell["limits"], device)
    host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    dev_peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_cuda else 0
    say(f"[check] reference {time.perf_counter() - t0:.3f} s; device peak "
        f"with the reference {dev_peak:.2f} GiB, host peak {host_peak:.2f} "
        f"GiB; {notes}")

    ok_run = w["attempted"] > 0 and w["failed"] == 0 and out["finite"]
    correct = ok_run and all(
        lim is not None and math.isfinite(v) and v <= lim
        for v, lim in checks.values())

    metrics = {}
    group = cell["per_layer"] if trace else cell["end_to_end"]
    for m in group:
        val = spec.metric_reader(m["name"], base)(ctx)
        if val is not None:
            metrics[m["name"]] = {"value": val, "unit": m["unit"]}

    device_info = {"platform": "gpu" if on_cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_cuda
                   else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": int(w["attempted"]),
              "failed": int(w["failed"]), "metrics": metrics,
              "device": device_info}
    if trace:
        s = ctx["trace"]
        device_info.update(busy_s=s["busy_s"], window_s=s["window_s"])
        result["breakdown"] = {"device_ops": s["device_ops"],
                               "idle_gaps": s["idle_gaps"]}
    result["notes"] = notes
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_env()
    import torch

    from port_bench import spec
    chips = {w["name"]: w for w in
             spec.load_benchmark(ROOT)["workloads"]}[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        say(f"no result: the cell needs {chips} CUDA device(s); "
            f"torch.cuda.is_available() {torch.cuda.is_available()}, "
            f"device_count {torch.cuda.device_count()}")
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        say(f"no result: modules of JAX or the JAX package are loaded: {bad}")
        return 4
    card = _card()
    say(f"[device] {card}")
    checks = result.pop("checks")
    result["card"] = card
    result["checks"] = checks
    for k, v in checks.items():
        say(f"check {k} {v['value']!r} limit {v['limit']!r}")
    say(f"correct {result['correct']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
