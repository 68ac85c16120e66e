from dafoam_tpu_torch.functions.registry import evaluate_function

__all__ = ["evaluate_function"]
