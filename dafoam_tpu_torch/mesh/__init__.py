"""Mesh: host topology (numpy) and device geometry (torch)."""

from dafoam_tpu_torch.mesh.generate import box_hex_mesh
from dafoam_tpu_torch.mesh.topology import MeshTopology, Patch

__all__ = ["MeshTopology", "Patch", "box_hex_mesh"]
