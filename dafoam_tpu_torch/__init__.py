"""dafoam_tpu_torch — the PyTorch/CUDA port of dafoam_tpu.

A second package beside ``dafoam_tpu`` (the JAX reference, which it never
imports). Module paths mirror the reference: ``mesh.topology``,
``ops.fvmatrix``, ``solvers.simple``, ... The banded LDU matvec and its
reverse rule run through hand-written CUDA kernels (``ops/dia_kernels.py``,
``csrc/dia_matvec.cu``), built with ``nvcc`` at first use on a CUDA
device; the OpenFOAM mesh parser (``native/ofparse.cpp``) is built with
``g++`` at first use. Importing the package builds and loads nothing.

Ported: every solver of dafoam_tpu (``make_solver``), both discrete
adjoints and the unsteady reverse sweeps with their total derivatives,
the MDO and coupling layer (``mdo/``, ``coupling/``), and IO and
utilities: the OpenFOAM polyMesh reader and writer
(``mesh.polymesh``), checkpoints, timing, pre/post-processing, the
Jacobian dump (``utils/``) and the command-line tools
(``python -m dafoam_tpu_torch.scripts.cli``), and multi-device
partitioning (``parallel/``: RCB, the halo-exchange LDU matvec over
partitions in one process or over ``torch.distributed`` ranks, and
``shard_solver``). Not ported: dafoam_tpu's GSPMD placement
(``dafoam_tpu.parallel.shard.shard_case``); see ``parallel/__init__.py``.

``DAOption`` is imported with the package, as in the reference
(``option`` needs only the standard library). ``make_solver``,
``box_hex_mesh`` and ``read_polymesh`` are importable from the package
itself; they load their modules on first access.
"""

__version__ = "0.1.0"

from dafoam_tpu_torch.option import DAOption  # noqa: F401,E402


def __getattr__(name):
    # lazy top-level conveniences (importing the package stays light)
    if name == "make_solver":
        from dafoam_tpu_torch.solvers import make_solver
        return make_solver
    if name == "box_hex_mesh":
        from dafoam_tpu_torch.mesh import box_hex_mesh
        return box_hex_mesh
    if name == "read_polymesh":
        from dafoam_tpu_torch.mesh.polymesh import read_polymesh
        return read_polymesh
    raise AttributeError(name)
