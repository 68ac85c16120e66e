"""kOmegaSSTLM and Spalart-Allmaras with Spalding wall functions against
dafoam_tpu: the checks of test_torch_turb.py (10 SIMPLE iterations at
pinned trip counts 1e-10, residuals and one vjp 1e-12, one step-map vjp
1e-10, the boundary nut, which is Spalding's at the SA case's walls) on
the same 16x8 channel, in a file of their own so that another test
worker takes them (the LM step map compiles for ~14 s on the JAX
side)."""

import pytest
import torch

from test_torch_turb import (check_residuals, check_simple_iterations,
                             check_step_map, run_model)

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=("kOmegaSSTLM", "SpalartAllmaras"))
def runs(request):
    return run_model(request.param)


def test_simple_iterations_match(runs):
    check_simple_iterations(runs)


def test_residuals_and_vjp_match(runs):
    check_residuals(runs)


def test_step_map_vjp_matches(runs):
    check_step_map(runs)
