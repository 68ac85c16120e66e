"""Bytes and flops of K1/K2/K3 against hand counts, the shapes recorded at
the program's wrappers, and the pairing of calls with traced launches."""

import pytest
import torch

from port_bench import roofline
from port_bench.trace import DiaCalls, dia_kind


def test_hand_counts():
    n, k = 10, 4
    # K1: diag n + bands k n + x n + y n floats; 2 (k + 1) n flops
    assert roofline.work("dia_matvec", n, k) == (4 * (n + k * n + 2 * n),
                                                  2 * 5 * n)
    assert roofline.work("dia_matvec_t", n, k) == roofline.work(
        "dia_matvec", n, k)
    # K2 with 3 components and a per-component diagonal
    assert roofline.work("dia_matvec_multi", n, k, 3, 3) == (
        4 * (3 * n + k * n + 6 * n), 2 * 5 * 3 * n)
    assert roofline.work("dia_matvec_multi", n, k, 3, 1, itemsize=8)[0] == \
        8 * (n + k * n + 6 * n)
    # K3b: reads ct and x, writes d̄ (n) and c̄ (k, n)
    assert roofline.work("dia_cotangent", n, k) == (4 * (3 + k) * n,
                                                     (k + 1) * n)
    b, f = roofline.work("dia_cotangent_multi", n, k, 3, per_component=True)
    assert b == 4 * (6 * n + 3 * n + k * n)
    assert f == (k + 1) * 3 * n + k * 2 * n
    b, f = roofline.work("dia_cotangent_multi", n, k, 3)
    assert b == 4 * (6 * n + n + k * n)
    assert f == (k + 1) * 3 * n + (k + 1) * 2 * n


def test_least_time_takes_the_larger_bound():
    b, f = 3.35e12, 1.0
    assert roofline.least_seconds(b, f) == pytest.approx(1.0)
    assert roofline.least_seconds(1.0, 67e12) == pytest.approx(1.0)
    assert roofline.least_seconds(1.0, 34e12, itemsize=8) == \
        pytest.approx(1.0)


def test_recorded_shapes_at_the_program_wrappers():
    from dafoam_tpu_torch.ops import dia_kernels as dk
    n, offs = 12, (1, 3, -2)
    d, c, x = torch.rand(n), torch.rand(3, n), torch.rand(n)
    xm, dm = torch.rand(2, n), torch.rand(2, n)
    rec = DiaCalls()
    with rec.active(dk):
        dk.dia_matvec(d, c, offs, x)     # not recorded while off
        rec.on = True
        y = dk.DiaMatvec.apply(d, c.requires_grad_(), x.requires_grad_(),
                               offs)
        y.sum().backward()
        dk.dia_matvec_multi(dm, c.detach(), offs, xm)
        dk.dia_cotangent_multi(xm, xm, offs, per_component=True)
    assert rec.calls["dia_matvec"] == [
        (*roofline.work("dia_matvec", n, 3), 4)]
    assert rec.calls["dia_matvec_t"] == [
        (*roofline.work("dia_matvec_t", n, 3), 4)]
    assert rec.calls["dia_cotangent"] == [
        (*roofline.work("dia_cotangent", n, 3), 4)]
    assert rec.calls["dia_matvec_multi"] == [
        (*roofline.work("dia_matvec_multi", n, 3, 2, 2), 4)]
    assert rec.calls["dia_cotangent_multi"] == [
        (*roofline.work("dia_cotangent_multi", n, 3, 2,
                        per_component=True), 4)]
    assert "call" not in dk.dia_matvec.__name__


def test_roofline_pairs_calls_with_launches():
    b, f = roofline.work("dia_matvec", 1000, 4)
    least = roofline.least_seconds(b, f)
    calls = {"dia_matvec": [(b, f, 4)] * 2}
    assert roofline.roofline_pct(calls, {"dia_matvec": [least, 3 * least]}) \
        == pytest.approx(50.0)
    assert roofline.roofline_pct(calls, {"dia_matvec": [least]}) is None
    assert roofline.roofline_pct({"dia_matvec": []}, {}) is None


def test_kernel_names():
    assert dia_kind("void dia_matvec_kernel<float>(float const*)") == \
        "dia_matvec"
    assert dia_kind("void dia_matvec_multi_t_kernel<float, 3>()") == \
        "dia_matvec_multi_t"
    assert dia_kind("void dia_cotangent_multi_kernel<double, 2>()") == \
        "dia_cotangent_multi"
    assert dia_kind("void at::native::reduce_kernel<512>()") is None
