"""Gradient-based shape-optimization driver (standalone MACH-Aero-lite).

Port of ``dafoam_tpu.mdo.optimize``. The reference drives optimization
through OpenMDAO/MPhys + pyOptSparse (user scripts,
tests/runRegTests_*.py; surrogate path pyDAFoam.py:2543
run_optimization). This driver provides the same capability standalone:

    DV -> FFD (mdo.ffd) -> IDW warp (mdo.warp) -> solve_primal ->
    J, constraints;  gradients by adjoint + one backward pass through
    warp o FFD (= DVGeo.totalSensitivity + IDWarp.warpDeriv in the
    reference chain, SURVEY.md §1 data-flow).

scipy.optimize (SLSQP/trust-constr) is the optimizer. OpenMDAO users get
the MPhys-compatible components in dafoam_tpu_torch.mdo.mphys instead.
"""

from __future__ import annotations

import numpy as np
import torch


class ShapeOptProblem:
    def __init__(self, solver, geo_fn, objective: str,
                 constraints: dict | None = None, dv_size: int | None = None):
        """geo_fn(dv) -> points (np,3): the composed FFD+warp chain (torch
        ops on the solver's device). objective/constraints: names in the
        solver's `function` option (constraints: {name: (lower, upper)})."""
        self.solver = solver
        self.geo_fn = geo_fn
        self.objective = objective
        self.constraints = constraints or {}
        self.dv_size = dv_size
        self._state = solver.init_state()
        self.history = []

    def _dv(self, dv):
        return torch.as_tensor(np.asarray(dv), dtype=self.solver.dtype,
                               device=self.solver.device)

    # -- primal at a DV point (warm-started) ---------------------------
    def _solve(self, dv):
        inputs = self.solver.make_inputs()
        with torch.no_grad():
            inputs["points"] = self.geo_fn(self._dv(dv))
        state, info = self.solver.run_primal(self._state, inputs)
        failed = bool(info.failed) or not bool(info.converged)
        if failed:
            # restart from a fresh state once (reference resetStateVals
            # behavior, DASolver.C:3715)
            state, info = self.solver.run_primal(self.solver.init_state(),
                                                 inputs)
            failed = bool(info.failed)
        if not failed:
            self._state = state
        return state, inputs, info

    def eval_all(self, dv):
        state, inputs, info = self._solve(dv)
        funcs = {n: float(self.solver.run_function(n, state, inputs))
                 for n in [self.objective, *self.constraints]}
        funcs["__failed__"] = bool(info.failed)
        self.history.append({"dv": np.asarray(dv).copy(), **funcs})
        return funcs, state, inputs

    def grad(self, dv, func_name, state, inputs):
        psi, ai = self.solver.run_adjoint(func_name, state, inputs)
        tot = self.solver.run_totals(func_name, state, inputs, psi)
        # chain through the geometry pipeline
        dvt = self._dv(dv).requires_grad_(True)
        with torch.enable_grad():
            pts = self.geo_fn(dvt)
        (ddv,) = torch.autograd.grad(pts, dvt, tot["points"])
        return ddv.detach().cpu().numpy().astype(np.float64)

    # -- scipy driver ----------------------------------------------------
    def run(self, dv0, bounds=None, maxiter=20, ftol=1e-7, method="SLSQP"):
        from scipy.optimize import minimize

        cache = {}

        def ensure(dvt):
            key = tuple(np.round(dvt, 14))
            if key not in cache:
                funcs, state, inputs = self.eval_all(np.asarray(dvt))
                cache.clear()
                cache[key] = (funcs, state, inputs)
            return cache[key]

        def f(dvt):
            funcs, *_ = ensure(dvt)
            return funcs[self.objective] + (1e3 if funcs["__failed__"] else 0)

        def fgrad(dvt):
            funcs, state, inputs = ensure(dvt)
            return self.grad(dvt, self.objective, state, inputs)

        cons = []
        for name, (lo, hi) in self.constraints.items():
            def cfun(dvt, name=name, lo=lo):
                funcs, *_ = ensure(dvt)
                return funcs[name] - lo

            def cjac(dvt, name=name):
                funcs, state, inputs = ensure(dvt)
                return self.grad(dvt, name, state, inputs)
            if lo is not None:
                cons.append({"type": "ineq", "fun": cfun, "jac": cjac})
            if hi is not None:
                def cfun2(dvt, name=name, hi=hi):
                    funcs, *_ = ensure(dvt)
                    return hi - funcs[name]

                def cjac2(dvt, name=name):
                    funcs, state, inputs = ensure(dvt)
                    return -self.grad(dvt, name, state, inputs)
                cons.append({"type": "ineq", "fun": cfun2, "jac": cjac2})

        res = minimize(f, np.asarray(dv0), jac=fgrad, bounds=bounds,
                       constraints=cons, method=method,
                       options={"maxiter": maxiter, "ftol": ftol})
        return res
