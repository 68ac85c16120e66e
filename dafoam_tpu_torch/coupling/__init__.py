from dafoam_tpu_torch.coupling.cht import CHTCoupling
from dafoam_tpu_torch.coupling.fsi import FSICoupling

__all__ = ["CHTCoupling", "FSICoupling"]
