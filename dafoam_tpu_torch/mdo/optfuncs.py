"""Optimization utility functions — reference ``OptFuncs``
(dafoam/mphys/mphys_dafoam.py:1107-1261).

``findFeasibleDesign`` locates design-variable values that satisfy
prescribed constraint targets (e.g. the angle of attack giving a target
CL) with a damped finite-difference Newton iteration driven through the
OpenMDAO ``Problem`` (real openmdao or the bundled ``om_shim``). A copy of
``dafoam_tpu.mdo.optfuncs`` (numpy only). Used to
obtain a feasible starting point before a gradient-based optimization.
"""

from __future__ import annotations

import numpy as np


class OptFuncs:
    """Reference parity: OptFuncs(daOptions, om_prob)
    (mphys_dafoam.py:1111-1130). ``comm`` is a no-op stand-in: the framework
    runs in one process."""

    def __init__(self, daOptions, om_prob):
        self.daOptions = daOptions
        self.om_prob = om_prob

    def findFeasibleDesign(self, constraints, designVars,
                           targets, constraintsComp=None,
                           designVarsComp=None, epsFD=None,
                           maxIter=10, tol=1e-4, maxNewtonStep=None):
        """FD-Newton on constraints(designVars) = targets
        (reference mphys_dafoam.py:1125-1246 semantics: square system,
        per-variable component indices, FD Jacobian re-built every
        iteration, step clipping by maxNewtonStep).

        Returns (converged: bool, norm: float, n_iters: int).
        """
        if len(constraints) != len(designVars):
            raise RuntimeError(
                "Sizes of the constraints and designVars lists need to be "
                "the same!")
        size = len(constraints)
        constraintsComp = constraintsComp or size * [0]
        designVarsComp = designVarsComp or size * [0]
        epsFD = epsFD or size * [1e-3]
        maxNewtonStep = maxNewtonStep or size * [1e16]
        targets = np.asarray(targets, dtype=float)

        prob = self.om_prob
        norm = np.inf
        n = 0
        for n in range(maxIter):
            prob.run_model()
            dv0 = np.array([np.atleast_1d(prob.get_val(designVars[i]))
                            [designVarsComp[i]] for i in range(size)])
            con0 = np.array([np.atleast_1d(prob.get_val(constraints[i]))
                             [constraintsComp[i]] for i in range(size)])
            res = con0 - targets
            norm = float(np.linalg.norm(res / targets))
            print(f"FindFeasibleDesign iter {n}: dv={dv0} con={con0} "
                  f"norm={norm:.6e}", flush=True)
            if norm < tol:
                print("FindFeasibleDesign Converged!", flush=True)
                return True, norm, n

            jac = np.zeros((size, size))
            for i in range(size):
                prob.set_val(designVars[i], dv0[i] + epsFD[i],
                             indices=designVarsComp[i])
                prob.run_model()
                prob.set_val(designVars[i], dv0[i],
                             indices=designVarsComp[i])
                for j in range(size):
                    conP = np.atleast_1d(prob.get_val(constraints[j]))[
                        constraintsComp[j]]
                    jac[j, i] = (conP - con0[j]) / epsFD[i]

            delta = -np.linalg.solve(jac, res)
            delta = np.clip(delta, -np.abs(maxNewtonStep),
                            np.abs(maxNewtonStep))
            for i in range(size):
                prob.set_val(designVars[i], dv0[i] + delta[i],
                             indices=designVarsComp[i])
        return norm < tol, norm, n
