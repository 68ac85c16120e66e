"""Fixed-point discrete adjoint and total derivatives (port of the
fixed-point half of ``dafoam_tpu.adjoint``)."""
