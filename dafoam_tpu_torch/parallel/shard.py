"""Opt a solver into the halo-exchange route.

Port of ``dafoam_tpu.parallel.shard.shard_solver``. ``shard_case``,
``mesh_axis_sharding``, ``replicated`` and ``device_mesh`` (dafoam_tpu's
GSPMD placement, whose collectives XLA's partitioner inserts) have no
counterpart here: see ``parallel/__init__.py``.
"""

from __future__ import annotations

import contextlib
import datetime
import os

import torch
import torch.distributed as dist

from dafoam_tpu_torch.parallel import halo


def shard_solver(solver, n_parts: int, group=None) -> halo.HaloMatvec:
    """Route every LDU product of ``solver.topo`` through a HaloMatvec.

    While the route is active, ``ops.fvmatrix.matvec``, ``matvec_fn`` and
    ``matvec_t_fn`` send the primal Krylov and smoother iterations, the
    implicit-rule transposes, the fixed-point and FGMRES adjoint products
    and the PC sweeps through it; vector solves run cell-major and pPC
    "line"/"mg" raise. ``halo.deactivate(solver.topo)`` ends it. Returns
    the HaloMatvec; ``hm.plan.cut_faces`` is the communication-volume
    diagnostic.

    The solver must be built on a partition-reordered topology
    (``parallel.partition.reorder_for_partitions`` with the same
    ``n_parts``) in the canonical face layout (``meshFaceLayout:
    "canonical"``): the plan needs owner-sorted, upper-triangular faces,
    which the dense-DIA layout's padded faces are not.

    ``group=None`` holds the P partitions in this process on the solver's
    device. With a ``torch.distributed`` group of ``n_parts`` ranks (NCCL
    for a CUDA solver, gloo on the CPU), this rank computes the rows of
    partition ``dist.get_rank(group)`` and every rank runs the rest of the
    solver redundantly on replicated tensors. Every rank must then take
    the same data-dependent branches (Krylov exits, the SIMPLE exit), so
    a CUDA group needs ``torch.use_deterministic_algorithms`` on (atomic
    scatters would otherwise round differently on each card):
    ``file_group`` turns it on, and this raises when it is off.
    """
    topo = solver.topo
    if topo.dia_dense() is not None:
        raise ValueError("the halo route needs the canonical face layout; "
                         "build the solver with meshFaceLayout 'canonical'")
    if topo.n_cells % int(n_parts):
        raise ValueError(f"n_cells {topo.n_cells} is not a multiple of "
                         f"{n_parts} partitions")
    if (group is not None and solver.device.type == "cuda"
            and not torch.are_deterministic_algorithms_enabled()):
        raise RuntimeError("a CUDA group needs deterministic algorithms so "
                           "that every rank takes the same branches; make "
                           "it with parallel.shard.file_group")
    return halo.activate(topo, n_parts, device=solver.device, group=group)


@contextlib.contextmanager
def file_group(path: str, rank: int, world_size: int, device,
               timeout_s: float = 60.0):
    """A process group of ``world_size`` ranks on one host for the
    distributed transport, as a context: the rendezvous goes through a
    ``file://`` store at ``path`` with a timeout, the backend is NCCL for
    a CUDA ``device`` and gloo otherwise. For NCCL, deterministic
    algorithms (and the fixed cuBLAS workspace they need) are on while
    the group lives, in every run of the process, the ranks' and any
    reference's alike; at exit the group is destroyed and both settings
    are restored."""
    cuda = torch.device(device).type == "cuda"
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{path}", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    was = torch.are_deterministic_algorithms_enabled()
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    try:
        if cuda:
            os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
            torch.use_deterministic_algorithms(True)
        yield dist.group.WORLD
    finally:
        torch.use_deterministic_algorithms(was)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        dist.destroy_process_group()
