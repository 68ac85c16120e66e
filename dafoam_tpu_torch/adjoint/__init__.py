"""Discrete adjoints and total derivatives (port of ``dafoam_tpu.adjoint``).

The package exports the residual-form functions of ``adjoint.solver``, as
the reference does; the fixed-point form (``adjoint_solve_fp``, ...),
the preconditioners (``adjoint.precond``) and the unsteady reverse sweeps
(``adjoint.unsteady``) are imported from their modules."""

from dafoam_tpu_torch.adjoint.solver import (adjoint_solve,
                                             forward_total_derivative,
                                             total_derivative)

__all__ = ["adjoint_solve", "total_derivative", "forward_total_derivative"]
