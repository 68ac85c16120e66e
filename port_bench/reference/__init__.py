"""The plain reference that decides ``correct``.

``plain.py`` is the steady incompressible SIMPLE iteration with
Spalart-Allmaras written from the finite-volume formulas in plain torch,
independent of the program and importing nothing of it. ``judge.py`` runs
it in float64 after the window on the inputs the benchmark made.
"""
