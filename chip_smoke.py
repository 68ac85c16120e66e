#!/usr/bin/env python3
"""Smoke run of dafoam_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases (any failure raises, so the exit code is nonzero; the 512x512
case is set up once, before phase 3, and reused by phase 5):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; fails when torch sees no CUDA device;
2. build: compiles the DIA kernels (dafoam_tpu_torch/csrc/dia_matvec.cu)
   with nvcc for sm_90a and reports the seconds and the ptxas summary;
3. kernel vs plain: K1 and K2 against their plain torch versions, float32
   and float64, on the band layout and coefficients of the first p,
   nuTilda and U matrices of the 512x512 NACA0012 case and on edge shapes;
   bars 1e-6 (f32) and 1e-13 (f64) relative to max|plain|; median times at
   262,144 cells from CUDA events;
4. golden: the 32x12 NACA0012 SA primal (f64, canonical layout, to
   primalMinResTol 1e-10) through the kernels; CD must match
   tests/golden/values.json naca_sa.CD at 1e-8, and both kernels must have
   been launched, their plain versions not;
5. full width: the 512x512 bench case (f32, dense-DIA layout) for 300 SIMPLE
   iterations (one BENCH_ITERS chunk); the state must stay finite and
   valid, the max residual must fall, CD must be finite, and the kernel
   launch counts must be positive with the plain counts at zero.

``--profile`` adds a torch.profiler table of one more SIMPLE iteration.
The last line of standard output is one JSON object with "ok" and the
device; the line before it lists every kernel with its launches in phase
5, its error against the plain version and both times.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
FULL = 512            # O-mesh cells per direction of the full-width case
ITERS = 300           # SIMPLE iterations of the full-width run
REL = {"float32": 1e-6, "float64": 1e-13}
NU = 1e-3
UINF = [1.0, 0.0, 0.0]
KERNELS = {
    "dia_matvec": {
        "replaces": "dafoam_tpu/ops/pallas_kernels.py:65 (dia_matvec), "
                    ":96 (dia_matvec_tiled)"},
    "dia_matvec_multi": {
        "replaces": "dafoam_tpu/ops/pallas_kernels.py:175 (dia_matvec_multi),"
                    " :219 (dia_matvec_multi_tiled)"},
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def naca_options(**over):
    opts = {
        "solverName": "DASimpleFoam",
        "turbulenceModel": "SpalartAllmaras",
        "transportProperties": {"nu": NU},
        "boundaryConditions": {
            "U": {"far": {"type": "inletOutlet", "value": UINF},
                  "wing": {"type": "fixedValue", "value": [0.0, 0.0, 0.0]}},
            "p": {"far": {"type": "fixedValue", "value": 0.0},
                  "wing": {"type": "zeroGradient"}},
            "nuTilda": {"far": {"type": "inletOutlet", "value": 3 * NU},
                        "wing": {"type": "fixedValue", "value": 0.0}},
        },
        "initialFields": {"U": UINF, "p": 0.0, "nuTilda": 3 * NU},
        "function": {"CD": {"type": "force", "patches": ["wing"],
                            "directionMode": "fixedDirection",
                            "direction": [1.0, 0.0, 0.0], "scale": 1.0}},
    }
    opts.update(over)
    return opts


def bench_options():
    """bench.py's flagship case, primal options (bench.py:93-142)."""
    return naca_options(
        primalMinResTol=0.0, primalMinIters=ITERS, primalMaxIters=ITERS,
        primalLinearSolver={"pMaxIters": 50, "pRelTol": 0.05,
                            "uMaxIters": 20, "uRelTol": 0.1,
                            "turbMaxIters": 20, "turbRelTol": 0.1},
        relaxationFactors={"fields": {"p": 0.2},
                           "equations": {"U": 0.5, "nuTilda": 0.5}},
        meshFaceLayout="diaDense")


def golden_options():
    """tests/test_golden.py:_case_naca_sa, primal options."""
    return naca_options(
        primalMinResTol=1e-10, primalMaxIters=1500,
        relaxationFactors={"fields": {"p": 0.2},
                           "equations": {"U": 0.5, "nuTilda": 0.5}},
        primalLinearSolver={"pMaxIters": 200, "pRelTol": 0.02,
                            "uMaxIters": 50, "uRelTol": 0.05,
                            "turbMaxIters": 50, "turbRelTol": 0.05},
        meshFaceLayout="canonical")


def say(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def phase_device(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices "
        f"{torch.cuda.device_count()} using {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build(dk):
    t0 = time.perf_counter()
    path = dk.build()
    dk._library()
    dt = time.perf_counter() - t0
    regs = [ln.strip() for ln in dk.build_log().splitlines()
            if "registers" in ln or "spill" in ln]
    say(f"[build] {path.name} ready in {dt:.2f} s")
    for ln in regs:
        say(f"[build] {ln}")


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, reps=15, inner=40):
    """Median milliseconds of one call, from CUDA events over ``inner``
    back-to-back calls, after a warm-up."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _kernel_events(prof):
    return [e for e in prof.events() if "CUDA" in str(e.device_type)]


def _event_us(e):
    return e.device_time_total      # a kernel event: its own duration


def device_us(torch, fn, calls=20):
    """Microseconds of device time per call (sum of the kernels one call
    launches), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(_event_us(e) for e in _kernel_events(prof)) / calls


def compare(torch, dk, name, diag, coef, offsets, x, stats, label):
    kern = getattr(dk, name)
    plain = getattr(dk, name + "_plain")
    y = kern(diag, coef, offsets, x)
    torch.cuda.synchronize()
    ref = plain(diag, coef, offsets, x)
    err = float((y - ref).abs().max()) if y.numel() else 0.0
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    dt = str(x.dtype).replace("torch.", "")
    check(bool(torch.isfinite(y).all()), f"{label}: non-finite kernel output")
    check(err <= REL[dt] * max(scale, 1e-300),
          f"{label} {dt}: max err {err:.3e} > {REL[dt]} x {scale:.3e}")
    st = stats.setdefault(name, {"max_abs_err": 0.0})
    st["max_abs_err"] = max(st["max_abs_err"], err)
    return err, scale


def phase_kernels(torch, dk, fvx, solver, stats, profile):
    dev = solver.device
    eqs = solver.equations(solver.init_state(), solver.make_inputs())
    gen = torch.Generator(device=dev).manual_seed(0)
    nc = solver.topo.n_cells
    real = []
    for field in ("p", "nuTilda", "U"):
        m = eqs[field]
        offsets, coef = fvx.dia_bands(m, solver.topo)
        if field == "U":
            diag = m.diag.t().contiguous()          # (3, nc) per component
            x = torch.randn((3, nc), generator=gen, device=dev)
            name = "dia_matvec_multi"
        else:
            diag = m.diag.contiguous()
            x = torch.randn((nc,), generator=gen, device=dev)
            name = "dia_matvec"
        real.append((field, name, offsets, diag, coef.contiguous(), x))
    say(f"[kernels] {FULL}x{FULL} bands: offsets {real[0][2]}, n = {nc}")
    for dtype in (torch.float32, torch.float64):
        for field, name, offsets, diag, coef, x in real:
            d, c, xx = (t.to(dtype) for t in (diag, coef, x))
            err, scale = compare(torch, dk, name, d, c, offsets, xx, stats,
                                 f"{field} matrix")
            say(f"[kernels] {name} {field} {dtype}: max abs err {err:.3e} "
                f"(max |y| {scale:.3e})")
        # the momentum matrix with a shared scalar diagonal
        _, _, offsets, diag, coef, x = real[2]
        compare(torch, dk, "dia_matvec_multi", diag[0].to(dtype).contiguous(),
                coef.to(dtype), offsets, x.to(dtype), stats, "U shared diag")

    # edge shapes: ragged n, offsets wider than a block, none, C=1/2/4,
    # n past the grid cap (grid-stride), 32 offsets
    rng = torch.Generator(device="cpu").manual_seed(1)
    wide = tuple(sorted(set(
        int(v) for v in torch.randint(-3000, 3000, (32,), generator=rng))))
    edges = [(1037, (-33, -1, 1, 33)), (20011, (-5000, -300, 1, 300, 5000)),
             (4097, ()), (2_100_000, (-1024, -1, 1, 1024)), (9001, wide),
             (1, (-1, 1)), (3, (5,))]
    for dtype in (torch.float32, torch.float64):
        for n, offsets in edges:
            d = torch.randn((n,), generator=gen, device=dev).to(dtype)
            c = torch.randn((len(offsets), n), generator=gen,
                            device=dev).to(dtype)
            x = torch.randn((n,), generator=gen, device=dev).to(dtype)
            compare(torch, dk, "dia_matvec", d, c, offsets, x, stats,
                    f"K1 n={n} K={len(offsets)}")
            for comps in (1, 2, 3, 4):
                xc = torch.randn((comps, n), generator=gen,
                                 device=dev).to(dtype)
                dc = torch.randn((comps, n), generator=gen,
                                 device=dev).to(dtype)
                compare(torch, dk, "dia_matvec_multi", d, c, offsets, xc,
                        stats, f"K2 C={comps} n={n}")
                compare(torch, dk, "dia_matvec_multi", dc, c, offsets, xc,
                        stats, f"K2 C={comps} n={n} per-comp diag")
    say(f"[kernels] edge shapes pass ({len(edges)} shapes x C in 1,2,3,4 x "
        "f32/f64)")

    # times at 262,144 cells, float32 and float64, kernel beside plain
    for dtype in (torch.float32, torch.float64):
        for field, name, offsets, diag, coef, x in real:
            d, c, xx = (t.to(dtype) for t in (diag, coef, x))
            kern = getattr(dk, name)
            plain = getattr(dk, name + "_plain")
            ms = cuda_ms(torch, lambda: kern(d, c, offsets, xx))
            pms = cuda_ms(torch, lambda: plain(d, c, offsets, xx))
            if dtype == torch.float32 and field in ("p", "U"):
                stats[name]["ms"], stats[name]["plain_ms"] = ms, pms
            say(f"[kernels] time {name} {field} {dtype}: kernel {ms:.4f} ms"
                f", plain {pms:.4f} ms (CUDA events, back-to-back calls)")
            if profile:
                kus = device_us(torch, lambda: kern(d, c, offsets, xx))
                pus = device_us(torch, lambda: plain(d, c, offsets, xx))
                say(f"[kernels] device time {name} {field} {dtype}: kernel "
                    f"{kus:.2f} us, plain {pus:.2f} us per call (profiler)")


# ---------------------------------------------------------------------------
# phase 4-5
# ---------------------------------------------------------------------------

def check_counts(counts, phase):
    for name in KERNELS:
        check(counts[name] > 0, f"{phase}: {name} was not launched")
        check(counts[name + "_plain"] == 0, f"{phase}: {name}_plain ran")


def phase_golden(torch, dk, make_solver, omesh):
    with open(os.path.join(HERE, "tests", "golden", "values.json")) as fh:
        want = json.load(fh)["naca_sa"]["CD"]
    pts, topo = omesh(n_wrap=32, n_radial=12, radius=15.0, first_cell=4e-3)
    s = make_solver(golden_options(), topo, pts, device=DEVICE,
                    dtype=torch.float64)
    check(s.topo.dia_dense() is None, "golden must run the canonical layout")
    inputs = s.make_inputs()
    st0 = s.init_state()
    dk.reset_counts()
    t0 = time.perf_counter()
    state, info = s.run_primal(st0, inputs)
    dt = time.perf_counter() - t0
    counts = dict(dk.COUNTS)
    cd = float(s.run_function("CD", state, inputs))
    rel = abs(cd - want) / abs(want)
    say(f"[golden] 32x12 f64 canonical: {info.iters} iters, max_res "
        f"{info.max_res:.3e}, converged {info.converged}, {dt:.1f} s; CD "
        f"{cd!r} vs golden {want!r} (rel {rel:.2e}); launch counts {counts}")
    check(info.converged and not info.failed, f"golden primal: {info}")
    check(rel <= 1e-8, f"golden CD off by {rel:.2e}")
    check_counts(counts, "golden")


def setup_full(torch, make_solver, omesh):
    t0 = time.perf_counter()
    pts, topo = omesh(n_wrap=FULL, n_radial=FULL, radius=15.0,
                      first_cell=4e-3)
    s = make_solver(bench_options(), topo, pts, device=DEVICE,
                    dtype=torch.float32)
    inputs = s.make_inputs()
    st0 = s.init_state()
    torch.cuda.synchronize()
    say(f"[full] {FULL}x{FULL} set-up (mesh, dense layout, geometry, wall "
        f"distance) {time.perf_counter() - t0:.1f} s; {s.topo.n_cells} "
        f"cells, offsets {s.topo.dia_dense()[0]}")
    return s, inputs, st0


def run_full(torch, dk, s, inputs, st0):
    """The main path: ITERS SIMPLE iterations in one run_primal call. One
    step from the same state, before the counts are reset, gives the first
    iteration's residual."""
    with torch.no_grad():
        res1 = float(s.primal_step(st0, inputs)[1])
    dk.reset_counts()
    s.solve_stats.clear()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, info = s.run_primal(st0, inputs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(dk.COUNTS)
    cd = float(s.run_function("CD", st, inputs))
    return st, res1, info, dt, counts, cd


def phase_profile(torch, s, inputs, st):
    from torch.profiler import ProfilerActivity, profile
    s.option.set("primalMinIters", 1)
    s.option.set("primalMaxIters", 1)
    s.run_primal(st, inputs)                 # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run_primal(st, inputs)                 # unprofiled wall time
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s.run_primal(st, inputs)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    key = "self_device_time_total" \
        if hasattr(ka[0], "self_device_time_total") else "self_cuda_time_total"
    say("[profile] one SIMPLE iteration, top 10 by device time:")
    say(ka.table(sort_by=key, row_limit=10, max_name_column_width=48))
    kernels = _kernel_events(prof)
    dia = [e for e in kernels if "dia_matvec" in e.name]
    syncs = sum(1 for e in prof.events()
                if e.name == "aten::_local_scalar_dense")
    busy_ms = sum(_event_us(e) for e in kernels) / 1e3
    say(f"[profile] {len(kernels)} device kernels ({len(dia)} DIA matvecs, "
        f"{sum(_event_us(e) for e in dia) / 1e3:.3f} ms), host syncs "
        f"(item/bool reads) {syncs}, device busy {busy_ms:.2f} ms of "
        f"{wall * 1e3:.2f} ms wall")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one SIMPLE iteration at 512x512")
    args = ap.parse_args()

    import torch
    card = phase_device(torch)

    sys.path.insert(0, HERE)
    from dafoam_tpu_torch.mesh.airfoil import omesh_naca0012
    from dafoam_tpu_torch.ops import dia_kernels as dk
    from dafoam_tpu_torch.ops import fvmatrix as fvx
    from dafoam_tpu_torch.solvers import make_solver

    phase_build(dk)
    stats = {}
    s, inputs, st0 = setup_full(torch, make_solver, omesh_naca0012)
    phase_kernels(torch, dk, fvx, s, stats, args.profile)
    phase_golden(torch, dk, make_solver, omesh_naca0012)

    st, res1, info, dt, counts, cd = run_full(torch, dk, s, inputs, st0)
    per = {k: v[1] / ITERS for k, v in s.solve_stats.items()}
    say(f"[full] {ITERS} SIMPLE iterations in {dt:.2f} s = "
        f"{dt / ITERS * 1e3:.2f} ms/iter; max_res first "
        f"{res1:.4e} final {info.max_res:.4e}; CD {cd!r}")
    say(f"[full] Krylov iterations per SIMPLE iteration: "
        + ", ".join(f"{k} {v:.2f}" for k, v in per.items())
        + f"; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    say(f"[full] launch counts {counts}")
    check(info.iters == ITERS, "iteration count")
    check(s.states_valid(st), "state is not finite/valid")
    check(not info.failed, f"primal failed: {info}")
    check(info.max_res < res1,
          f"max_res did not fall: {res1} -> {info.max_res}")
    check(math.isfinite(cd), f"CD not finite: {cd}")
    check_counts(counts, "full width")

    if args.profile:
        phase_profile(torch, s, inputs, st)

    rows = []
    for name, meta in KERNELS.items():
        st_k = stats[name]
        rows.append({"name": name, "route": "cuda",
                     "source": "dafoam_tpu_torch/csrc/dia_matvec.cu",
                     "replaces": meta["replaces"],
                     "launches": counts[name],
                     "max_abs_err": st_k["max_abs_err"],
                     "ms": st_k["ms"], "plain_ms": st_k["plain_ms"]})
    say(json.dumps({"kernels": rows}))
    say(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
