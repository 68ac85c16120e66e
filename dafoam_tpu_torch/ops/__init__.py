from dafoam_tpu_torch.ops import bc, fvc, fvm
from dafoam_tpu_torch.ops.fvmatrix import FvMatrix

__all__ = ["bc", "fvc", "fvm", "FvMatrix"]
