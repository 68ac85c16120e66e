#!/usr/bin/env python3
"""Parity checks of dafoam_tpu_torch against dafoam_tpu that decide whether
an effect seen on the card is the port's or shared (CPU, both packages).

    python3 scripts/torch_parity_checks.py rho N [--iters 300] [--dt 1e-4]
    python3 scripts/torch_parity_checks.py scl N [--f64]
    python3 scripts/torch_parity_checks.py fsi NX NY [--chip-options]
    python3 scripts/torch_parity_checks.py floor N [--jax]

- ``rho``: chip_smoke.py phase 11b's case at N x N: ``iters`` f64
  DARhoSimpleFoam iterations of phase 9's options in the port, then from
  that state the DARhoPimpleFoam steps (deltaT ``dt``) in the port (f64
  and f32) and in dafoam_tpu (f64); prints rho's range after the steps.
- ``scl``: the SCL residual of phase 12's first step of motion at N x N
  (max over cells of |sum of mesh fluxes| / sum of their magnitudes) from
  each package's ``mesh_phi``, in f32 (``--f64``: both in f64).
- ``fsi``: the flexible wall of tests/test_torch_coupling.py (NX x NY
  fluid over an NX x max(3, NY/2) plate; default 10 5: the test's own
  case), f32: one 60-iteration coupled-adjoint GMRES cycle per package
  after the coupled primal; prints GMRES's residual estimate and psi's true
  residual in the normalizeStates metric. ``--chip-options``: phase 18's
  primal options instead of the test's.
- ``floor``: chip_smoke.py phase 15a's steady scalar transport at N x N,
  f32: psi's true residual after 10-60 FGMRES iterations of the port's
  default-PC adjoint beside GMRES's estimate (``--jax``: dafoam_tpu's
  unpreconditioned adjoint to rel 1e-12 within 400 iterations).

dafoam_tpu runs under ``jax.config`` x64 as the precision says; nothing
here touches the card.
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))


def _jax(x64):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", x64)
    return jax


def _omesh(n):
    return dict(n_wrap=n, n_radial=n, radius=15.0, first_cell=4e-3)


def check_rho(args):
    import numpy as np
    jax = _jax(True)
    import jax.numpy as jnp
    import torch

    import chip_smoke as cs
    from dafoam_tpu.mesh.airfoil import omesh_naca0012 as jom
    from dafoam_tpu.solvers import make_solver as jmake
    from dafoam_tpu_torch import convert
    from dafoam_tpu_torch.mesh.airfoil import omesh_naca0012 as tom
    from dafoam_tpu_torch.solvers import make_solver as tmake

    pt, tt = tom(**_omesh(args.n))
    o9 = cs.rho_options(meshFaceLayout="canonical", primalMinIters=args.iters,
                        primalMaxIters=args.iters)
    s9 = tmake(o9, tt, pt, device="cpu", dtype=torch.float64)
    x9 = s9.make_inputs()
    st9, info = s9.run_primal(s9.init_state(), x9)
    with torch.no_grad():
        r9 = s9.rho_of(st9, x9)
    print(f"[rho] {args.n}x{args.n}: {args.iters} f64 SIMPLE iterations, "
          f"max_res {info.max_res:.3e}, rho [{float(r9.min()):.4f}, "
          f"{float(r9.max()):.4f}]")
    st9n = convert.state_to_numpy(st9)
    op = cs.rho_options(solverName="DARhoPimpleFoam", deltaT=args.dt,
                        endTime=cs.RHO_PIMPLE_STEPS * args.dt,
                        meshFaceLayout="canonical")
    port = None
    for dt in (torch.float64, torch.float32):
        s = tmake(op, tt, pt, device="cpu", dtype=dt)
        x = s.make_inputs()
        with torch.no_grad():
            st, _ = s.solve_primal_history(
                convert.state_from_numpy(st9n, "cpu", dt), x)
            rho = s.rho_of(st, x)
        if port is None:
            port = rho.numpy()
        print(f"[rho] port {dt} {cs.RHO_PIMPLE_STEPS} steps of {args.dt}: "
              f"rho [{float(rho.min()):.6f}, {float(rho.max()):.6f}]")
    pj, tj = jom(**_omesh(args.n))
    js = jmake(op, tj, pj)
    jx = js.make_inputs()
    jst, _ = jax.jit(js.solve_primal_history)(
        {k: jnp.asarray(v) for k, v in st9n.items()}, jx)
    jrho = np.asarray(js.rho_of(jst, jx))
    print(f"[rho] dafoam_tpu f64: rho [{jrho.min():.6f}, {jrho.max():.6f}]; "
          f"max |rho_port - rho_dafoam_tpu| {np.abs(port - jrho).max():.3e}")


def _scl(mphi, topo):
    import numpy as np
    ni = topo.n_internal
    own, nei = np.asarray(topo.owner), np.asarray(topo.neighbour)
    net = np.zeros(topo.n_cells, mphi.dtype)
    mag = np.zeros(topo.n_cells, mphi.dtype)
    np.add.at(net, own, mphi[:len(own)])
    np.add.at(net, nei, -mphi[:ni])
    np.add.at(mag, own, np.abs(mphi[:len(own)]))
    np.add.at(mag, nei, np.abs(mphi[:ni]))
    return float(np.max(np.abs(net) / np.where(mag > 0, mag, 1)))


def check_scl(args):
    import numpy as np
    jax = _jax(args.f64)
    import torch

    import chip_smoke as cs
    from dafoam_tpu.mesh.airfoil import omesh_naca0012 as jom
    from dafoam_tpu.solvers import make_solver as jmake
    from dafoam_tpu_torch.mesh.airfoil import omesh_naca0012 as tom
    from dafoam_tpu_torch.solvers import make_solver as tmake

    opts = dict(cs.dym_options(), meshFaceLayout="canonical")
    dt = torch.float64 if args.f64 else torch.float32
    pt, tt = tom(**_omesh(args.n))
    s = tmake(opts, tt, pt, device="cpu", dtype=dt)
    x = s.make_inputs()
    with torch.no_grad():
        p0, p1 = s.points_at(x, 0.0), s.points_at(x, s.dt)
        scl = s.scl_residual(p0, p1, s.dt)
        mt = s.mesh_phi(p0, p1, s.dt).numpy()
    pj, tj = jom(**_omesh(args.n))
    js = jmake(opts, tj, pj)
    xj = js.make_inputs()
    mj = np.asarray(jax.jit(lambda a, b: js.mesh_phi(a, b, js.dt))(
        js.points_at(xj, 0.0), js.points_at(xj, js.dt)))
    print(f"[scl] {args.n}x{args.n} {dt}: port scl_residual {scl:.6e}, "
          f"through this metric {_scl(mt, tt):.6e}; dafoam_tpu "
          f"{_scl(mj, tj):.6e}; max |mesh_phi| {np.abs(mj).max():.4e}, the "
          f"packages' mesh fluxes {np.abs(mj - mt).max():.3e} apart")


def check_fsi(args):
    jax = _jax(False)
    import jax.numpy as jnp
    import torch

    import chip_smoke as cs
    import test_torch_coupling as tc
    from dafoam_tpu.coupling import FSICoupling
    from dafoam_tpu.linalg.krylov import gmres
    from dafoam_tpu.mesh import box_hex_mesh as jbox
    from dafoam_tpu.solvers import make_solver as jmake
    from dafoam_tpu_torch.examples import fsi_flexible_wall as fsi_ex

    if args.chip_options:
        fo = {"primalMinResTol": 0.0, "primalMaxIters": cs.CPL_SIMPLE,
              "primalLinearSolver": dict(cs.CPL_LINEAR)}
        so = {"primalMinResTol": 0.0, "primalMaxIters": cs.CPL_PICARD}
        outer = cs.CPL_OUTER
    else:
        fo = tc._pin({}, tc.N_SIMPLE)
        so = dict(tc.SOLID_OVER["fsi"])
        outer = tc.N_OUTER
    side, func, _ = tc.CASES["fsi"]
    iters = 60
    cpl = fsi_ex.build("cpu", torch.float32, nx=args.nx, ny_fluid=args.ny,
                       ny_solid=max(3, args.ny // 2),
                       fluid_over=dict(fo, meshFaceLayout="canonical"),
                       solid_over=dict(so, meshFaceLayout="canonical"))
    f, s = cpl.fluid, cpl.solid
    inf, ins = f.make_inputs(), s.make_inputs()
    sf, ss, _ = cpl.solve_primal(f.init_state(), s.init_state(), inf, ins,
                                 n_outer=outer)
    _, _, ai, psi = cpl.solve_adjoint(sf, ss, inf, ins, side, func,
                                      restart=iters, rel_tol=1e-9,
                                      max_iters=iters, return_psi=True)
    true = cs._coupled_true_resid(torch, cpl, {"fluid": sf, "solid": ss},
                                  inf, ins, side, func, psi)
    print(f"[fsi] {args.nx}x{args.ny} f32 port: {ai.iters} iterations, "
          f"resid0 {ai.resid0:.6e}, estimate {ai.resid:.6e}, true {true:.6e}"
          f" ({(true - ai.resid) / ai.resid:+.4%})")

    (pf, tf_), (ps, ts_) = fsi_ex.meshes(args.nx, args.ny,
                                         max(3, args.ny // 2), box=jbox)
    jc = FSICoupling(jmake(fsi_ex.fluid_options(**fo), tf_, pf),
                     jmake(fsi_ex.solid_options(**so), ts_, ps),
                     "ymin", "ymax")
    jf, js = jc.fluid, jc.solid
    jinf, jins = jf.make_inputs(), js.make_inputs()
    jsf, jss, _ = jax.jit(lambda a, b: jc.solve_primal(
        jf.init_state(), js.init_state(), a, b, n_outer=outer))(jinf, jins)
    W = {"fluid": jsf, "solid": jss}
    dJ = jax.grad(lambda w: jc.eval_function(w, jinf, jins, side, func))(W)
    sc = {"fluid": jf.state_scales(jf.geometry(jinf)),
          "solid": js.state_scales(js.geometry(jins))}

    def scale(t, invert=False):
        return {d: {k: v / sc[d].get(k, 1.0) if invert
                    else v * sc[d].get(k, 1.0) for k, v in sub.items()}
                for d, sub in t.items()}

    _, f_vjp = jax.vjp(lambda w: jc.residuals(w, jinf, jins), W)
    matT = jax.jit(lambda p: scale(f_vjp(scale(p, invert=True))[0]))
    b = scale(dJ)
    # dafoam_tpu's FSICoupling.solve_adjoint keeps psi to itself: its GMRES
    # on the same operator, as there
    psi_s, info = gmres(matT, b, restart=iters, rel_tol=1e-9,
                        max_iters=iters)
    r = jax.tree_util.tree_map(lambda a, c: a - c, matT(psi_s), b)
    jtrue = float(jnp.sqrt(sum(jnp.sum(v ** 2)
                               for v in jax.tree_util.tree_leaves(r))))
    est = float(info.resid)
    print(f"[fsi] {args.nx}x{args.ny} f32 dafoam_tpu: {int(info.iters)} "
          f"iterations, resid0 {float(info.resid0):.6e}, estimate "
          f"{est:.6e}, true {jtrue:.6e} ({(jtrue - est) / est:+.4%})")


def check_floor(args):
    import torch

    import chip_smoke as cs
    cs.FULL = args.n
    cs.DEVICE = "cpu"
    opts = cs.scalar_full_options()
    if args.jax:
        jax = _jax(False)
        import jax.numpy as jnp
        from dafoam_tpu.mesh import box_hex_mesh
        from dafoam_tpu.solvers import make_solver
        opts.update(meshFaceLayout="canonical", adjEqnOption=dict(
            opts["adjEqnOption"], gmresRelTol=1e-12, gmresRestart=400,
            gmresMaxIters=400, pcType="none"))
        pts, topo = box_hex_mesh(args.n, args.n, 1, (1.0, 0.6, 0.1),
                                 kinds={"zmin": "empty", "zmax": "empty"})
        s = make_solver(opts, topo, pts)
        x = s.make_inputs()
        x["params"]["U"] = jnp.broadcast_to(
            jnp.asarray([0.4, 0.0, 0.0], s.dtype), (topo.n_cells, 3))
        st, _ = s.run_primal(s.init_state(), x)
        psi, ai = s.solve_adjoint(st, x, "TMean")
        dJ = jax.grad(lambda w: s.eval_function("TMean", w, x))(st)
        _, f_vjp = jax.vjp(lambda w: s._norm_residuals(w, x), st)
        g = f_vjp(psi)[0]
        sc = s.state_scales(s.geometry(x))
        true = float(jnp.sqrt(sum(jnp.sum((sc[k] * (g[k] - dJ[k])) ** 2)
                                  for k in g)))
        print(f"[floor] {args.n}x{args.n} f32 dafoam_tpu, no PC: "
              f"{int(ai.iters)} iterations, resid0 {float(ai.resid0):.4e}, "
              f"estimate {float(ai.resid):.4e}, true {true:.4e}")
        return
    from dafoam_tpu_torch.mesh import box_hex_mesh
    from dafoam_tpu_torch.solvers import make_solver
    s, x = cs._scalar_box(torch, make_solver, box_hex_mesh, opts)
    st, _ = s.run_primal(s.init_state(), x)
    for it in (10, 20, 40, 60):
        s.option["adjEqnOption"].update(gmresRelTol=1e-12,
                                        gmresRestart=it, gmresMaxIters=it)
        psi, ai = s.solve_adjoint(st, x, "TMean")
        true = cs._true_resid(torch, s, st, x, "TMean", psi)
        print(f"[floor] {args.n}x{args.n} f32 port, segregated PC: "
              f"{ai.iters} iterations, resid0 {ai.resid0:.4e}, estimate "
              f"{ai.resid:.4e}, true {true:.4e}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="check", required=True)
    p = sub.add_parser("rho")
    p.add_argument("n", type=int)
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--dt", type=float, default=1e-4)
    p = sub.add_parser("scl")
    p.add_argument("n", type=int)
    p.add_argument("--f64", action="store_true")
    p = sub.add_parser("fsi")
    p.add_argument("nx", type=int, nargs="?", default=10)
    p.add_argument("ny", type=int, nargs="?", default=5)
    p.add_argument("--chip-options", action="store_true")
    p = sub.add_parser("floor")
    p.add_argument("n", type=int)
    p.add_argument("--jax", action="store_true")
    args = ap.parse_args()
    import torch
    torch.set_num_threads(4)
    {"rho": check_rho, "scl": check_scl, "fsi": check_fsi,
     "floor": check_floor}[args.check](args)


if __name__ == "__main__":
    main()
