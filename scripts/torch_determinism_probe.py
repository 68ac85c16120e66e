#!/usr/bin/env python3
"""What ``torch.use_deterministic_algorithms`` changes in a CUDA run of
dafoam_tpu_torch.

    python3 scripts/torch_determinism_probe.py [--iters 3] [--sweeps 2]
                                               [--no-cpu] [--no-replay]

The case is chip_smoke.py's 1-rank NCCL check without the group: the FULL
x FULL cavity box relabelled into SHARD_PARTS RCB parts, ``iters``
fixed-work SIMPLE outers, ``sweeps`` Richardson sweeps of the fixed-point
adjoint and the lidF totals, float64, on the local halo route with P = 1.
It runs on the card three times in default mode and twice with
deterministic algorithms on, each after emptying the allocator's cache,
once more with deterministic algorithms on but uninitialized memory not
filled (a result that moves then reads memory no operator wrote), and
once on the CPU (whose scatters are sequential). It prints the largest
difference of U, J, psi (every field), dJ/dnu and dJ/dpoints between
every two runs, the points totals also in their two parts (the
objective's partial and psibar^T dG/dpoints), and the points where two
card runs differ most, with every run's value there.

Then it runs the deterministic case once more under a dispatch mode that
repeats every operator with deterministic algorithms off, on copies of
its inputs, and prints the operators whose two results differ: the stage
(primal, adjoint, totals), the count, the largest difference, the largest
|output| and the largest difference relative to it. Results also go to
chiprun_out/determinism_probe.json.
"""

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten, tree_map  # noqa: E402

import chip_smoke as cs  # noqa: E402

STAGE = ["set-up"]
SKIP = {"empty", "empty_like", "empty_strided", "new_empty",
        "new_empty_strided", "_local_scalar_dense", "set_", "resize_"}


class Replay(TorchDispatchMode):
    """Runs each operator twice, deterministic algorithms off (on copies
    of the inputs) and then as called, and keeps per (stage, operator)
    the largest difference of the two results."""

    def __init__(self):
        super().__init__()
        self.stats = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        alt = None
        if name not in SKIP and not func.is_view and "as_strided" not in name:
            copies = tree_map(lambda t: t.clone() if isinstance(
                t, torch.Tensor) else t, (args, kwargs))
            torch.use_deterministic_algorithms(False)
            try:
                alt = func(*copies[0], **copies[1])
            finally:
                torch.use_deterministic_algorithms(True)
        out = func(*args, **kwargs)
        if alt is not None:
            self._record(name, out, alt)
        return out

    def _record(self, name, out, alt):
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        alts = [t for t in tree_flatten(alt)[0] if isinstance(t, torch.Tensor)]
        for a, b in zip(outs, alts):
            if a.shape != b.shape or not a.numel():
                continue
            st = self.stats.setdefault((STAGE[0], name), {
                "calls": 0, "differ": 0, "max_diff": 0.0, "max_out": 0.0,
                "max_rel": 0.0, "dtype": str(a.dtype)})
            st["calls"] += 1
            if a.is_floating_point():
                diff = float((a - b).abs().max())
                scale = float(a.abs().max())
            else:
                diff = float((a != b).sum())
                scale = float(a.numel())
            if math.isnan(diff):                  # one side not finite
                diff = math.inf
            if diff > 0:
                st["differ"] += 1
                st["max_diff"] = max(st["max_diff"], diff)
                st["max_out"] = max(st["max_out"], scale)
                st["max_rel"] = max(st["max_rel"], diff / max(scale, 1e-300))


def run(pts, topo, device, iters, sweeps):
    """The fixed-work run of chip_smoke.fixed_work on the local halo route
    with P = 1, with STAGE set per stage. The points totals come in their
    two parts, as adjoint.solver.total_derivative_fp sums them: the
    objective's own partial pJ/px and psibar^T pG/px through the step
    map."""
    from dafoam_tpu_torch.adjoint import solver as adj
    from dafoam_tpu_torch.linalg import fvsolve
    from dafoam_tpu_torch.parallel import halo, shard_solver
    from dafoam_tpu_torch.solvers import make_solver
    s = make_solver(cs.shard_fixed_options(iters, sweeps),
                    dataclasses.replace(topo), pts, device=device,
                    dtype=torch.float64)
    shard_solver(s, 1)
    try:
        x = s.make_inputs()
        t0 = time.perf_counter()
        STAGE[0] = "primal"
        with fvsolve.fixed_inner(1.0):
            st, _ = s.run_primal(s.init_state(), x)
        J = float(s.run_function("lidF", st, x))
        STAGE[0] = "adjoint"
        psi, _ = s.solve_adjoint(st, x, "lidF")
        STAGE[0] = "totals"
        xg = adj._requiring_grad(x)
        with torch.enable_grad():
            jx = s.eval_function("lidF", st, xg)
        pjx = adj._grad(jx, xg)
        step = s._fp_step_fn()
        _, fx_vjp = adj.vjp(lambda xx: step(st, xx)[0], x)
        gx = fx_vjp(psi)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        STAGE[0] = "set-up"
        halo.deactivate(s.topo)
    out = {"U": st["U"], "phi": st["phi"], "J": torch.tensor(J),
           **{f"psi_{k}": v for k, v in psi.items()},
           "dJdnu": pjx["params"]["nu"] + gx["params"]["nu"],
           "pJ_points": pjx["points"], "psiG_points": gx["points"],
           "dJdpoints": pjx["points"] + gx["points"]}
    return {k: v.detach().double().cpu() for k, v in out.items()}, dt


def diffs(a, b):
    return {k: [float((a[k] - b[k]).abs().max()), float(b[k].abs().max())]
            for k in a}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--sweeps", type=int, default=2)
    ap.add_argument("--no-cpu", action="store_true")
    ap.add_argument("--no-replay", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    import torch.utils.deterministic as tud
    from dafoam_tpu_torch.mesh import box_hex_mesh
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    pts, topo, _ = cs.shard_box(box_hex_mesh, cs.SHARD_PARTS)
    kw = dict(iters=args.iters, sweeps=args.sweeps)
    # (name, deterministic algorithms, fill uninitialized memory)
    specs = [("default1", False, True), ("default2", False, True),
             ("det1", True, True), ("default3", False, True),
             ("det2", True, True), ("det_nofill", True, False)]
    runs, times = {}, {}
    for name, det, fill in specs:
        torch.cuda.empty_cache()
        torch.use_deterministic_algorithms(det)
        tud.fill_uninitialized_memory = fill
        try:
            runs[name], times[name] = run(pts, topo, "cuda", **kw)
        finally:
            torch.use_deterministic_algorithms(False)
            tud.fill_uninitialized_memory = True
    if not args.no_cpu:
        torch.set_num_threads(os.cpu_count() or 1)
        runs["cpu"], times["cpu"] = run(pts, topo, "cpu", **kw)
    report = {"case": f"{cs.FULL}x{cs.FULL} cavity box in {cs.SHARD_PARTS} "
                      f"RCB parts, P = 1 local halo route, f64, {args.iters} "
                      f"outers, {args.sweeps} sweeps",
              "seconds": times, "pairs": {}}
    names = list(runs)
    worst = (0.0, None)
    for i, a in enumerate(names):
        for b in names[:i]:
            d = diffs(runs[a], runs[b])
            report["pairs"][f"{a} - {b}"] = d
            print(f"[probe] {a} - {b}: " + ", ".join(
                f"{k} {e:.3e}" for k, (e, _) in d.items() if e > 0),
                flush=True)
            if "cpu" not in (a, b) and d["dJdpoints"][0] > worst[0]:
                worst = (d["dJdpoints"][0], (a, b))
    print("[probe] largest |value| per quantity: " + ", ".join(
        f"{k} {float(v.abs().max()):.3e}" for k, v in runs[names[0]].items()))
    if worst[1] is not None:
        a, b = worst[1]
        diff = (runs[a]["dJdpoints"] - runs[b]["dJdpoints"]).abs()
        flat = diff.reshape(-1)
        top = torch.topk(flat, min(8, flat.numel())).indices.tolist()
        n_big = int((diff.amax(dim=1) > 1e-10 * float(
            runs[b]["dJdpoints"].abs().max())).sum())
        print(f"[probe] {a} - {b}: {n_big} points differ by more than 1e-10"
              " of the largest entry; the largest differences (point, "
              "component, coordinates, value per run):")
        rows = []
        for f in top:
            i, c = divmod(f, 3)
            vals = {n: float(r["dJdpoints"][i, c]) for n, r in runs.items()}
            parts = {n: [float(r["pJ_points"][i, c]),
                         float(r["psiG_points"][i, c])]
                     for n, r in runs.items()}
            rows.append({"point": i, "component": c,
                         "xyz": [float(v) for v in pts[i]],
                         "dJdpoints": vals, "pJ_psiG": parts})
            print(f"[probe]   point {i} comp {c} at "
                  f"{[round(float(v), 6) for v in pts[i]]}: " + ", ".join(
                      f"{n} {v:.6e}" for n, v in vals.items()), flush=True)
        report["largest"] = rows
        ni = topo.n_internal
        pa, pb = runs[a]["phi"][:ni], runs[b]["phi"][:ni]
        flip = (pa >= 0) != (pb >= 0)
        report["upwind_flips"] = {
            "faces": int(flip.sum()),
            "max_abs_phi": float(torch.maximum(pa.abs(), pb.abs())[flip].max())
            if bool(flip.any()) else 0.0,
            "max_abs_phi_all": float(pa.abs().max())}
        print(f"[probe] {a} - {b}: {report['upwind_flips']['faces']} "
              "internal faces where phi >= 0 (the upwind branch) differs, "
              f"|phi| there at most {report['upwind_flips']['max_abs_phi']:.3e}"
              f" (max |phi| {report['upwind_flips']['max_abs_phi_all']:.3e})",
              flush=True)

    if not args.no_replay:
        torch.use_deterministic_algorithms(True)
        mode = Replay()
        try:
            with mode:
                replayed, _ = run(pts, topo, "cuda", **kw)
        finally:
            torch.use_deterministic_algorithms(False)
        d = diffs(replayed, runs["det1"])
        print("[probe] replayed deterministic run - det1: " + ", ".join(
            f"{k} {e:.3e}" for k, (e, _) in d.items()), flush=True)
        rows = sorted(({"stage": k[0], "op": k[1], **v}
                       for k, v in mode.stats.items()),
                      key=lambda r: -r["max_rel"])
        report["ops"] = rows
        print(f"[probe] {len(rows)} (stage, operator) pairs, "
              f"{sum(r['calls'] for r in rows)} results compared; those "
              "whose two results differ, by largest relative difference:")
        for r in rows:
            if r["differ"]:
                print(f"[probe]   {r['stage']:8s} {r['op']:28s} "
                      f"{r['dtype']:14s} differ {r['differ']:6d} of "
                      f"{r['calls']:6d}, max diff {r['max_diff']:.3e}, max "
                      f"|out| {r['max_out']:.3e}, rel {r['max_rel']:.3e}",
                      flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "determinism_probe.json"),
              "w") as fh:
        json.dump(report, fh, indent=1)


if __name__ == "__main__":
    main()
