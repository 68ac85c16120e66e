"""Time-spectral (harmonic-balance) periodic scalar transport (port of
``dafoam_tpu.solvers.time_spectral``).

The reference's option surface has an ``unsteadyAdjoint`` mode "hybrid"
(pyDAFoam.py:398-409); only a comment there names ``nTimeInstances`` and
``periodicity``, and no reference solver implements the mode. Here a
periodic flow is N (odd) coupled time instances at t_n = n T/N solved as
ONE steady system, with the spectral time derivative

    (dW/dt)_n = sum_m D_nm W_m,
    D_nm = (pi/T) (-1)^(n-m) / sin(pi (n-m)/N),  D_nn = 0,

exact on every harmonic the N instances resolve. The coupled residual is
R_n = R_spatial(W_n; t_n) + (D W)_n; time-dependent BCs (multiFreqScalar)
are evaluated at each instance's own t_n.

- primal: block Gauss-Seidel over the instances, each instance's spatial
  operator solved implicitly (BiCGStab through K1) with the spectral
  coupling as an explicit source and an implicit pseudo-time term, one
  host check of the stacked residual per sweep. The inner solves take
  ``primalLinearSolver.turbRelTol``/``turbMaxIters``, the keys the port's
  other scalar solves read (dafoam_tpu hard-codes 1e-12 and 2000, which
  f32 never reaches: every solve would run its full budget);
- adjoint, totals, forward mode: the base class's residual form on the
  stacked state (no reverse time sweep). ``pcType`` takes the block
  diagonal of the instances' transport matrices (transposed products
  through K3a); dafoam_tpu runs this GMRES unpreconditioned;
- objectives: ``timeops.time_op`` over the instances, whose "average"
  window defaults to the whole cycle.

Selected by ``solverName: DAScalarTransportFoam`` with
``unsteadyAdjoint: {"mode": "hybrid", "nTimeInstances": N,
"periodicity": T}``, or directly as ``DATimeSpectralScalarFoam``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dafoam_tpu_torch.functions import evaluate_function
from dafoam_tpu_torch.linalg import fvsolve
from dafoam_tpu_torch.ops import bc, fvm
from dafoam_tpu_torch.ops import fvmatrix as fvx
from dafoam_tpu_torch.option import DAOption
from dafoam_tpu_torch.solvers.base import PrimalInfo
from dafoam_tpu_torch.solvers.scalar_transport import DAScalarTransportFoam
from dafoam_tpu_torch.states import StateInfo
from dafoam_tpu_torch.timeops import time_op


def spectral_derivative_matrix(n: int, period: float) -> np.ndarray:
    """The odd-N time-spectral d/dt operator (numpy, (n, n))."""
    if n < 3 or n % 2 == 0:
        raise ValueError(
            f"nTimeInstances must be odd and >= 3, got {n} "
            "(even-N time-spectral operators are rank-deficient on the "
            "Nyquist mode)")
    j = np.arange(n)
    diff = j[:, None] - j[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        d = (np.pi / float(period)) * ((-1.0) ** diff) \
            / np.sin(np.pi * diff / n)
    np.fill_diagonal(d, 0.0)
    return d


class DATimeSpectralScalarFoam(DAScalarTransportFoam):
    """Time-spectral periodic scalar transport (see module docstring)."""

    def __init__(self, option, topo, points, *, device, dtype):
        opt = option if isinstance(option, DAOption) else DAOption(option)
        ua = opt["unsteadyAdjoint"]
        self.n_inst = int(ua.get("nTimeInstances", 3))
        self.period = float(ua.get("periodicity", 1.0))
        # per-instance states, before the base class builds the layout
        self.state_info = StateInfo(
            vol_scalar=tuple(f"T{n}" for n in range(self.n_inst)))
        super().__init__(opt, topo, points, device=device, dtype=dtype)
        d = spectral_derivative_matrix(self.n_inst, self.period)
        self._D = self._tensor(d)
        # pseudo-time stabilization of the block Gauss-Seidel sweep: the
        # explicit coupling has row magnitude max_n sum_m |D_nm|, which at
        # high reduced frequency rivals the spatial diagonal; an implicit
        # vol/dtau with dtau = pseudoTimeFactor / that row sum keeps the
        # sweep diagonally dominant (it cancels at convergence)
        row = float(np.max(np.sum(np.abs(d), axis=1)))
        fac = float(ua.get("pseudoTimeFactor", 1.0))
        self._pseudo_inv_dt = row / fac if fac > 0.0 else 0.0

    # -- per-instance plumbing -----------------------------------------
    def _t_of(self, n: int) -> float:
        return n * self.period / self.n_inst

    def _bco_T(self, T, inputs, geom, phi, t):
        return bc.coeffs(self.bc_spec["T"], inputs["bc"].get("T", {}),
                         self.topo, geom, T, rank=0,
                         phi_b=phi[self.topo.n_internal:], t=t)

    def _assemble_at(self, T, inputs, geom, phi, t):
        """The parent's transport matrix with the instance's BC time."""
        bco = self._bco_T(T, inputs, geom, phi, t)
        gamma_f = torch.broadcast_to(inputs["params"]["DT"],
                                     (self.topo.n_faces,))
        return fvm.div(geom, self.topo, phi, T, bco, scheme=self.div_scheme) \
            - fvm.laplacian(geom, self.topo, gamma_f, T, bco)

    # -- state management ----------------------------------------------
    def init_state(self) -> dict:
        st = self.layout.zeros(self.dtype, device=self.device)
        t0 = self._tensor(self.option.get("initialFields", {}).get("T", 0.0))
        return {k: torch.broadcast_to(t0, v.shape).clone()
                for k, v in st.items()}

    def state_scales(self, geom) -> dict:
        s = self._tensor(self.option["normalizeStates"].get("T", 1.0))
        return {f"T{n}": s for n in range(self.n_inst)}

    # -- coupled steady residual ---------------------------------------
    def residuals(self, state, inputs):
        geom = self.geometry(inputs)
        phi = self._phi(inputs, geom)
        ts = torch.stack([state[f"T{n}"] for n in range(self.n_inst)])
        ddt = self._D @ ts                          # (N, nc), exact d/dt
        out = {}
        for n in range(self.n_inst):
            m = self._assemble_at(ts[n], inputs, geom, phi, self._t_of(n))
            out[f"T{n}"] = fvx.residual(m, ts[n], geom, self.topo) + ddt[n]
        return out

    # -- primal: block Gauss-Seidel over instances ---------------------
    def solve_primal(self, state, inputs):
        geom = self.geometry(inputs)
        phi = self._phi(inputs, geom)
        vol = geom.vol
        tol = self.option["primalMinResTol"]
        max_sweeps = self.option["primalMaxIters"]
        lin = self.option["primalLinearSolver"]
        names = [f"T{n}" for n in range(self.n_inst)]
        pdt = self._pseudo_inv_dt
        st, it, res = dict(state), 0, math.inf
        while it < max_sweeps and res > tol:
            ts = [st[nm] for nm in names]
            for n in range(self.n_inst):
                m = self._assemble_at(ts[n], inputs, geom, phi,
                                      self._t_of(n))
                # explicit spectral source (D_nn == 0) plus the implicit
                # pseudo-time term, in the volume-integrated convention
                ddt_n = sum(self._D[n, k] * ts[k]
                            for k in range(self.n_inst) if k != n)
                m = m._replace(diag=m.diag + vol * pdt,
                               source=m.source - vol * ddt_n
                               + vol * pdt * ts[n])
                ts[n], info = fvsolve.solve(
                    m, ts[n], self.topo, symmetric=False,
                    rel_tol=lin["turbRelTol"], max_iters=lin["turbMaxIters"])
                self._log_solve("T", info)
            st = dict(st, **dict(zip(names, ts)))
            it += 1
            r = self.residuals(st, inputs)
            res = float(torch.stack([torch.max(torch.abs(v))
                                     for v in r.values()]).max())
        return st, PrimalInfo(it, res, res <= tol, not self.states_valid(st))

    # -- adjoint preconditioner ------------------------------------------
    def _pc_matrices(self, state, inputs, geom):
        """{"T<n>": instance n's transport matrix}: the block diagonal of
        dR/dW (D_nn == 0, so the spectral coupling has no diagonal
        block)."""
        with torch.no_grad():
            phi = self._phi(inputs, geom)
            return {f"T{n}": (self._assemble_at(state[f"T{n}"], inputs, geom,
                                                phi, self._t_of(n)), False)
                    for n in range(self.n_inst)}

    # -- objectives: DATimeOp reduction over the cycle -----------------
    def _instance_ctx(self, state, inputs, n, geom, phi):
        tn = state[f"T{n}"]
        bco = self._bco_T(tn, inputs, geom, phi, self._t_of(n))
        return {"state": {"T": tn}, "geom": geom, "topo": self.topo,
                "boundary": {"T": bc.boundary_value(bco, tn, self.topo)},
                "phi": phi, "aux": {}, "data": inputs.get("data", {})}

    def boundary_fields(self, state, inputs, geom):
        phi = self._phi(inputs, geom)
        return {f"T{n}": bc.boundary_value(
            self._bco_T(state[f"T{n}"], inputs, geom, phi, self._t_of(n)),
            state[f"T{n}"], self.topo) for n in range(self.n_inst)}

    def eval_function(self, name, state, inputs):
        cfg = self.option["function"][name]
        if cfg["type"] == "residualNorm":
            raise NotImplementedError(
                "residualNorm objectives are not defined for the "
                "time-spectral mode (the converged TS residual is zero "
                "by construction)")
        geom = self.geometry(inputs)
        phi = self._phi(inputs, geom)
        vals = torch.stack([
            evaluate_function(cfg, self._instance_ctx(state, inputs, n,
                                                      geom, phi))
            for n in range(self.n_inst)])
        # every instance carries equal cycle weight: the "average" window
        # defaults to the whole cycle (an explicit timeOpFracStart wins)
        cfg_ts = dict(cfg)
        cfg_ts.setdefault("timeOpFracStart", 0.0)
        return time_op(vals, cfg.get("timeOp", "average"), cfg_ts)
