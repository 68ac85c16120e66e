#!/usr/bin/env python3
"""The device PCG's kernels and its block size on one card.

    python3 scripts/torch_pcg_probe.py [--out pcg_probe.json] [--reps 5]

At 917,504 cells (256 x 3584) in float32, on the pressure-like 5-point
matrix of tests/test_torch_pcg.py:

1. device time per call (torch.profiler, chip_smoke.device_us) of K1,
   pcg_init, pcg_dot, pcg_update and pcg_direction, and of krylov.cg's
   torch ops for the same work;
2. the wall time of one solve (host clock, synchronised) of krylov.cg
   and of krylov.dia_pcg at blocks of 1 to 50 iterations and iteration
   caps of 20 to 50, in turns, with its reads and masked iterations, and
   the least-squares fit wall = c0 + c_iter iters + c_read reads
   + c_masked masked, which prices a read against a masked iteration;
3. solves that exit on their tolerance, as PIMPLE's p, InterFoam's p_rgh
   and the implicit rule's transpose solves do: caps of 1,000 at rel_tol
   0.05 to 1e-4 on three right-hand sides each, krylov.cg against
   dia_pcg at blocks of 1 to 40, with the iterations and the masked ones.

Prints one JSON object (and writes it to --out).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

BLOCKS = (1, 2, 4, 5, 8, 10, 12, 16, 25, 50)
CAPS = (50, 43, 37, 20)
TOL_BLOCKS = (1, 5, 10, 20, 40)
TOL_RELS = (0.05, 1e-2, 1e-3, 1e-4)
TOL_CAP = 1000


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip()


def kernel_times(torch, mat, b):
    from dafoam_tpu_torch.linalg.krylov import _guard
    from dafoam_tpu_torch.ops import dia_kernels as dk
    from dafoam_tpu_torch.ops import pcg_kernels as pk
    d, c, o, dinv = mat
    x, r = torch.zeros_like(b), b.clone()
    z, p = torch.empty_like(b), torch.empty_like(b)
    st = pk.PcgState(x, r, z, p, dinv)
    pk.pcg_init(st, 1e12, 0.0, 0.0)
    ap = dk.dia_matvec(d, c, o, p)
    tp = 1.1754943508222875e-38
    rz = torch.ones((), device=b.device)
    out = {
        "K1": cs.device_us(torch, lambda: dk.dia_matvec(d, c, o, p)),
        "pcg_init": cs.device_us(
            torch, lambda: pk.pcg_init(st, 1e12, 0.0, 0.0)),
    }
    # live, a small step, no exit
    st.s[pk.ALPHA] = 1e-6
    st.s[pk.BETA] = 0.5
    out["pcg_dot"] = cs.device_us(torch, lambda: pk.pcg_dot(st, ap))
    st.s[pk.ALPHA] = 1e-6
    out["pcg_update"] = cs.device_us(torch, lambda: pk.pcg_update(st, ap))
    out["pcg_direction"] = cs.device_us(torch, lambda: pk.pcg_direction(st))
    # host time per call (enqueue, no wait), live
    calls = {"K1": lambda: dk.dia_matvec(d, c, o, p),
             "pcg_dot": lambda: pk.pcg_dot(st, ap),
             "pcg_update": lambda: pk.pcg_update(st, ap),
             "pcg_direction": lambda: pk.pcg_direction(st)}
    for name, fn in calls.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        out[f"host_{name}"] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    # parts of a launch's host time
    parts = {
        "stream": lambda: torch.cuda.current_stream(b.device).cuda_stream,
        "empty_like": lambda: torch.empty_like(p),
        "K1_checks": lambda: dk._check(
            "dia_matvec", p, o, {"diag": (d, ((p.shape[0],),)),
                                 "coef": (c, ((len(o), p.shape[0]),)),
                                 "x": (p, ((p.shape[0],),))}),
    }
    st.s[pk.LIVE] = 0.0
    head, tail = st.args["pcg_direction"]
    fn = st.fn["pcg_direction"]
    parts["ctypes_launch"] = lambda: fn(*head, *tail)
    for name, f in parts.items():
        t0 = time.perf_counter()
        for _ in range(200):
            f()
        out[f"host_part_{name}"] = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    # krylov.cg's torch ops for the same work
    out["cg_dot_ops"] = cs.device_us(
        torch, lambda: rz / _guard(torch.sum(p * ap), tp))
    alpha = rz / _guard(torch.sum(p * ap), tp)

    def cg_update():
        xx = x + alpha * p
        rr = r - alpha * ap
        zz = dinv * rr
        rzn = torch.sum(rr * zz)
        return xx, rzn / _guard(rz, tp), torch.sqrt(torch.sum(rr * rr))

    out["cg_update_ops"] = cs.device_us(torch, cg_update)
    out["cg_direction_ops"] = cs.device_us(torch, lambda: alpha * p + z)
    return out


def solve_times(torch, mat, b, reps):
    from dafoam_tpu_torch.linalg import krylov
    from dafoam_tpu_torch.ops import dia_kernels as dk
    d, c, o, dinv = mat

    def run_cg(cap):
        return krylov.cg(lambda v: dk.dia_matvec(d, c, o, v), b,
                         precond=lambda r: dinv * r, rel_tol=0.0,
                         max_iters=cap)

    def run_pcg(cap):
        return krylov.dia_pcg(d, c, o, dinv, b, rel_tol=0.0, max_iters=cap)

    def wall(fn, cap):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(cap)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    rows, cg_ms = [], {}
    for cap in CAPS:
        run_cg(cap)
        cg_ms[cap] = 1e3 * statistics.median(wall(run_cg, cap)
                                             for _ in range(reps))
    for rep in range(reps):
        order = BLOCKS if rep % 2 == 0 else BLOCKS[::-1]
        for k in order:
            krylov.PCG_BLOCK["cuda"] = k
            for cap in CAPS:
                if rep == 0:
                    run_pcg(cap)
                krylov.reset_counts()
                t = wall(run_pcg, cap)
                masked = krylov.COUNTS["pcg_masked_iters"]
                rows.append({"block": k, "cap": cap, "ms": 1e3 * t,
                             "reads": (cap + masked) // k,
                             "masked": masked})
    return rows, cg_ms


def tolerance_exits(torch, mat, reps):
    """Caps of TOL_CAP at each of TOL_RELS on three right-hand sides:
    krylov.cg's wall ms and iterations, dia_pcg's at each of TOL_BLOCKS
    with its masked iterations (medians of ``reps``, in turns)."""
    from dafoam_tpu_torch.linalg import krylov
    from dafoam_tpu_torch.ops import dia_kernels as dk
    d, c, o, dinv = mat
    dev = d.device

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), out[1]

    out = []
    for seed in (21, 22, 23):
        g = torch.Generator(device=dev).manual_seed(seed)
        b = torch.randn(d.shape[0], device=dev, generator=g)
        for rel in TOL_RELS:
            def cg():
                return krylov.cg(lambda v: dk.dia_matvec(d, c, o, v), b,
                                 precond=lambda r: dinv * r, rel_tol=rel,
                                 max_iters=TOL_CAP)

            def pcg():
                return krylov.dia_pcg(d, c, o, dinv, b, rel_tol=rel,
                                      max_iters=TOL_CAP)

            row = {"seed": seed, "rel_tol": rel, "pcg": {}}
            times = {"cg": []}
            for rep in range(reps):
                ms, info = wall(cg)
                times["cg"].append(ms)
                row["cg_iters"] = info.iters
                order = TOL_BLOCKS if rep % 2 == 0 else TOL_BLOCKS[::-1]
                for k in order:
                    krylov.PCG_BLOCK["cuda"] = k
                    krylov.reset_counts()
                    ms, info = wall(pcg)
                    times.setdefault(k, []).append(ms)
                    row["pcg"][k] = {
                        "iters": info.iters,
                        "masked": krylov.COUNTS["pcg_masked_iters"]}
            row["cg_ms"] = statistics.median(times.pop("cg"))
            for k, v in times.items():
                row["pcg"][k]["ms"] = statistics.median(v)
            out.append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
    return out


def fit(rows):
    import numpy as np
    a = np.array([[1.0, r["cap"], r["reads"], r["masked"]] for r in rows])
    y = np.array([r["ms"] for r in rows])
    coef, *_ = np.linalg.lstsq(a, y, rcond=None)
    return dict(zip(("c0_ms", "c_iter_ms", "c_read_ms", "c_masked_ms"),
                    (float(v) for v in coef)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from dafoam_tpu_torch.linalg import krylov
    dev = torch.device("cuda")
    mat = cs.pressure_matrix(*cs.PCG_BENCH, torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(11)
    b = torch.randn(mat[0].shape[0], device=dev, generator=g)
    res = {"card": card(), "cells": int(b.shape[0]),
           "torch": torch.__version__,
           "kernel_us": kernel_times(torch, mat, b)}
    block = krylov.PCG_BLOCK["cuda"]
    res["tolerance_exits"] = tolerance_exits(torch, mat, 3)
    krylov.PCG_BLOCK["cuda"] = block
    rows, cg_ms = solve_times(torch, mat, b, args.reps)
    res["cg_solve_ms"] = cg_ms
    med = {}
    for r in rows:
        med.setdefault(f"{r['block']}@{r['cap']}", []).append(r["ms"])
    res["pcg_solve_ms"] = {k: statistics.median(v) for k, v in med.items()}
    res["fit"] = fit(rows)
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
