#!/usr/bin/env python3
"""Two probes on the card that PERF.md's open questions cite.

    python3 scripts/torch_fsi_fwad_probe.py

1. Forward-mode AD's cost per op: 200 products of a dual tensor with a
   plain tensor, with a Python number and with another dual, and of two
   plain tensors, 262,144 float32 values each, on the host CPU and on
   the card (host clock around a synchronised loop). A plain operand's
   tangent is an efficient zero tensor, whose output torch shapes through
   a Python meta kernel.
2. chip_smoke.py phase 18's FSI drive (the flexible wall at CPL_NX x
   CPL_NY, f32) with default algorithms and again with
   ``torch.use_deterministic_algorithms(True)``: each run prints the
   coupled psi's true residual beside GMRES's estimate ([fsi] lines), so
   a gap that the card's summation order makes would differ between the
   two.

Needs a CUDA device; about 3 minutes with the kernels' build.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def forward_ad_costs(torch, say, n=262144, reps=200):
    import torch.autograd.forward_ad as fwAD
    for dev in ("cpu", "cuda"):
        x, t, p = (torch.randn(n, device=dev) for _ in range(3))
        with fwAD.dual_level():
            d = fwAD.make_dual(x, t)
            d2 = fwAD.make_dual(p, torch.zeros_like(p))
            for name, f in (("dual*plain", lambda: d * p),
                            ("dual*2.0", lambda: d * 2.0),
                            ("dual*dual", lambda: d * d2),
                            ("plain*plain", lambda: x * p)):
                f()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    f()
                torch.cuda.synchronize()
                say(f"[fwad] torch {torch.__version__} {dev} {name}: "
                    f"{(time.perf_counter() - t0) / reps * 1e6:.1f} us per op")


def main():
    # deterministic CUDA algorithms need cuBLAS's fixed workspace, set
    # before cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise SystemExit("torch_fsi_fwad_probe: no CUDA device")
    card = cs.phase_device(torch)
    from dafoam_tpu_torch.examples import fsi_flexible_wall as fsi_ex
    from dafoam_tpu_torch.ops import dia_kernels as dk
    cs.phase_build(dk)
    forward_ad_costs(torch, cs.say)
    fluid_over = {"primalMinResTol": 0.0, "primalMaxIters": cs.CPL_SIMPLE,
                  "primalLinearSolver": dict(cs.CPL_LINEAR)}
    for mode in ("default", "deterministic"):
        torch.use_deterministic_algorithms(mode == "deterministic")
        fsi = fsi_ex.build(cs.DEVICE, torch.float32, nx=cs.CPL_NX,
                           ny_fluid=cs.CPL_NY, ny_solid=cs.CPL_NY // 2,
                           fluid_over=fluid_over,
                           solid_over={"primalMinResTol": 0.0,
                                       "primalMaxIters": cs.CPL_PICARD})
        cs.say(f"[fsi-mode] {mode}")
        try:
            cs._coupled(torch, dk, fsi, "fsi", "fluid", "drag",
                        ("interface displacement", lambda sf, ss, inf, ins:
                         fsi.interface_displacement(ss, ins)),
                        ("params", "E"), ("solid", ("params", "E")))
        except cs.SmokeFailure as e:
            cs.say(f"[fsi-mode] {mode}: a check failed: {e}")
        del fsi
    torch.use_deterministic_algorithms(False)
    cs.say(card)


if __name__ == "__main__":
    main()
