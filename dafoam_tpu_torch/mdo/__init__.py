from dafoam_tpu_torch.mdo.ffd import FFDBox
from dafoam_tpu_torch.mdo.warp import IDWarp

__all__ = ["FFDBox", "IDWarp"]
