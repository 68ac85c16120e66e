#!/usr/bin/env python3
"""Where chip_smoke.py phase 11b's rho spread comes from, on the card.

    python3 scripts/torch_rho_pimple_probe.py [--n 512]

Phase 9's DARhoSimpleFoam state (ITERS f32 SIMPLE iterations on the N x N
O-mesh, dense layout) is stepped RHO_PIMPLE_STEPS times by
DARhoPimpleFoam, as phase 11b does, in f32 and in f64, on the dense and
on the canonical layout, from the same state. Each run prints rho's range
after the steps and the O-mesh (wrap, radial) index of the cells that
hold the extremes (wrap 0 and N-1 meet at the trailing edge, radial 0 is
the wall), and the mesh's worst checkMesh qualities.
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=512)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise SystemExit("torch_rho_pimple_probe: no CUDA device")
    card = cs.phase_device(torch)
    from dafoam_tpu_torch.mesh.airfoil import omesh_naca0012
    from dafoam_tpu_torch.mesh.check import check_mesh
    from dafoam_tpu_torch.mesh.geometry import compute_geometry
    from dafoam_tpu_torch.ops import dia_kernels as dk
    from dafoam_tpu_torch.solvers import make_solver
    cs.phase_build(dk)
    n = args.n
    pts, topo = omesh_naca0012(n_wrap=n, n_radial=n, radius=15.0,
                               first_cell=4e-3)
    s9 = make_solver(cs.rho_options(), topo, pts, device="cuda",
                     dtype=torch.float32)
    x9 = s9.make_inputs()
    st9, info = s9.run_primal(s9.init_state(), x9)
    with torch.no_grad():
        r9 = s9.rho_of(st9, x9)
    cs.say(f"[rho-probe] {n}x{n}: {info.iters} f32 SIMPLE iterations, "
           f"max_res {info.max_res:.4e}, rho [{float(r9.min()):.4f}, "
           f"{float(r9.max()):.4f}]")
    _, q = check_mesh(compute_geometry(torch.as_tensor(
        pts, dtype=torch.float64, device="cuda"), topo), topo,
        cs.O_MESH_THRESHOLD)
    cs.say("[rho-probe] mesh: " + ", ".join(f"{k} {v}"
                                            for k, v in q.items()))
    canon = {k: v.detach() for k, v in st9.items()}
    fmap = getattr(s9.topo, "face_map_old2new", None)
    if fmap is not None:
        canon["phi"] = canon["phi"][torch.as_tensor(fmap, device="cuda")]
    for layout in ("diaDense", "canonical"):
        for dtype in (torch.float32, torch.float64):
            s = make_solver(cs.rho_options(
                solverName="DARhoPimpleFoam", deltaT=cs.RHO_PIMPLE_DT,
                endTime=cs.RHO_PIMPLE_STEPS * cs.RHO_PIMPLE_DT,
                meshFaceLayout=layout), topo, pts, device="cuda",
                dtype=dtype)
            x = s.make_inputs()
            st0 = st9 if layout == "diaDense" else canon
            with torch.no_grad():
                st, _ = s.solve_primal_history(
                    {k: v.to(dtype) for k, v in st0.items()}, x)
                rho = s.rho_of(st, x)
            lo, hi = int(torch.argmin(rho)), int(torch.argmax(rho))
            cs.say(f"[rho-probe] {layout} {dtype}: rho "
                   f"[{float(rho.min()):.6f}, {float(rho.max()):.6f}]; min "
                   f"at (wrap, radial) {(lo % n, lo // n)}, max at "
                   f"{(hi % n, hi // n)}; valid {s.states_valid(st)}")
    cs.say(card)


if __name__ == "__main__":
    main()
