"""Multi-device partitioning: port of ``dafoam_tpu.parallel``.

- ``partition``: recursive coordinate bisection and the relabelling into
  contiguous partition blocks (``reorder_for_partitions``);
- ``halo``: the halo plan and ``HaloMatvec``, the partitioned LDU product
  with its local (P partitions in one process) and distributed
  (``torch.distributed``, one partition per rank) transports;
- ``shard``: ``shard_solver``, which routes every LDU product of a solver
  through the halo route.

Not ported: dafoam_tpu's GSPMD placement (``shard_case``,
``mesh_axis_sharding``, ``replicated``, ``device_mesh``). There XLA's SPMD
partitioner places globally indexed arrays on a device mesh and inserts
the collectives; PyTorch has no partitioner that the solvers could run
under, and that partitioner's miscompile of the pressure assembly is the
reason dafoam_tpu's halo route exists. The halo route is the port's
multi-device path.
"""

from dafoam_tpu_torch.parallel.halo import (HaloMatvec, HaloPlan, activate,
                                            active, build_halo_plan,
                                            deactivate)
from dafoam_tpu_torch.parallel.partition import (cut_statistics,
                                                 partition_cells,
                                                 reorder_for_partitions)
from dafoam_tpu_torch.parallel.shard import shard_solver

__all__ = ["HaloMatvec", "HaloPlan", "activate", "active", "build_halo_plan",
           "cut_statistics", "deactivate", "partition_cells",
           "reorder_for_partitions", "shard_solver"]
