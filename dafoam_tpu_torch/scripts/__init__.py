"""Command-line tools of dafoam_tpu_torch (``scripts.cli``)."""
