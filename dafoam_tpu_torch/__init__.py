"""dafoam_tpu_torch — the PyTorch/CUDA port of dafoam_tpu.

A second package beside ``dafoam_tpu`` (the JAX reference, which it never
imports). Module paths mirror the reference: ``mesh.topology``,
``ops.fvmatrix``, ``solvers.simple``, ... The banded LDU matvec runs
through hand-written CUDA kernels (``ops/dia_kernels.py``,
``csrc/dia_matvec.cu``), built with ``nvcc`` at first use on a CUDA
device; importing the package builds and loads nothing.

Ported so far: the DASimpleFoam + Spalart–Allmaras primal, the force
objective, and the fixed-point discrete adjoint with its total derivatives
(the banded matvec's reverse rule K3 is a hand-written kernel too; see
ROADMAP.md for what follows).
"""

__version__ = "0.1.0"
