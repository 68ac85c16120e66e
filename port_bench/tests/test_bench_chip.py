"""On the card: the program's DIA kernels appear in the trace with one
recorded call per launch, and their roofline share stays under 100%."""

import pytest

pytestmark = pytest.mark.chip


def test_traced_chunk_reads_the_kernels(cuda_device, small_bench):
    from port_bench import run
    root, base = small_bench
    r = run.run("sa_primal_1m", 17, 0.0, True, device=cuda_device,
                size=(256, 128), base=base, root=root)
    m = r["metrics"]
    assert r["correct"], r["checks"]
    assert m["primal.kernels_per_iter"]["value"] > 100
    assert 0.0 < m["dia_roofline.primal"]["value"] <= 100.0
    assert 0.0 <= m["idle_pct.primal"]["value"] < 100.0
    assert r["device"]["busy_s"] > 0.0


def test_main_refuses_a_run_without_enough_devices(cuda_device, monkeypatch):
    import torch

    from port_bench import run
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(["--workload", "sa_primal_1m", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 3
