"""Mesh: host topology (numpy) and device geometry (torch)."""

from dafoam_tpu_torch.mesh.topology import MeshTopology, Patch

__all__ = ["MeshTopology", "Patch"]
