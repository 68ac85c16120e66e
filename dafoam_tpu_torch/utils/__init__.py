from dafoam_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from dafoam_tpu_torch.utils.timing import Timer

__all__ = ["save_checkpoint", "load_checkpoint", "Timer"]
