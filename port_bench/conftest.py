"""Test settings of the benchmark's own tests (``port_bench/tests``).

Tests that need an NVIDIA GPU carry the ``chip`` marker and take the
``cuda_device`` fixture, which skips them when there is no card; the check
is made inside the fixture, so every worker collects the same tests.
"""

import os
import shutil

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA GPU (run on the card: python -m "
        "pytest port_bench/tests -m chip)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"


@pytest.fixture
def small_bench(tmp_path):
    """A benchmark root in ``tmp_path``: BENCHMARK.json and a copy of the
    benchmark's files, for tests that add files to it. Returns (root,
    base)."""
    base = tmp_path / "port_bench"
    for sub in ("configs", "reference", "traffic", "workloads", "metrics"):
        shutil.copytree(os.path.join(HERE, sub), base / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(os.path.dirname(HERE), "BENCHMARK.json"),
                tmp_path / "BENCHMARK.json")
    return str(tmp_path), str(base)
