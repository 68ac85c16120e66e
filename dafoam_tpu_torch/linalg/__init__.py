from dafoam_tpu_torch.linalg.krylov import SolveInfo, bicgstab, cg, gmres

__all__ = ["cg", "bicgstab", "gmres", "SolveInfo"]
