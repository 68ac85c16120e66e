"""Mesh: host topology (numpy) and device geometry (torch)."""

from dafoam_tpu_torch.mesh.generate import box_hex_mesh
from dafoam_tpu_torch.mesh.geometry import MeshGeometry, compute_geometry
from dafoam_tpu_torch.mesh.topology import MeshTopology, Patch

__all__ = ["MeshTopology", "Patch", "MeshGeometry", "compute_geometry",
           "box_hex_mesh"]
