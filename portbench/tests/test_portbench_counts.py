"""Operation and byte counts against hand-worked values at small shapes, and the trace arithmetic."""

from __future__ import annotations

import pytest

from portbench import run, spec
from portbench.metrics import k3_roofline, k5_roofline
from portbench.yardstick import bounds
from portbench.yardstick import trace as tr

B, F = bounds.HBM_BYTES_PER_S, bounds.FP32_OPS_PER_S


def us(seconds: float) -> float:
    return 1e6 * seconds


def test_k3_bound_at_2_by_3():
    # G in, L and G^-1 out: 3 * 2 * 9 + 2 = 56 floats = 224 B; 2 * 27 = 54 operations.
    assert bounds.bound_us("chol_inv_logdet", 2, 3) == pytest.approx(max(us(224 / B), us(54 / F)))


def test_k1_bound_at_2_by_3():
    # G in, L out: 2 * 2 * 9 = 36 floats = 144 B; 2 * 9 = 18 operations.
    assert bounds.bound_us("cholesky", 2, 3) == pytest.approx(us(144 / B))


def test_k4_and_k5_bounds_at_c2_n3_d2():
    # K4: X (6) + w, pm, u0, wf (4 * 2 * 2) + dt (2) = 24 floats; 2 chains x 1 round x
    # (2*3*2 + 3*2*3 + 8/3 + 2*4) = 2 * 40.667 operations.
    assert bounds.fixed_point_bound_us("position_fixed_point", 2, 3, 2, 1) == pytest.approx(
        max(us(96 / B), us(2 * (12 + 18 + 8 / 3 + 8) / F)))
    # K5: X (6) + G^-1 (8) + c (6) + 4 * 2 * 2 + 2 = 38 floats; 2 x 3 rounds x (8 + 24 + 9).
    assert bounds.fixed_point_bound_us("momentum_fixed_point", 2, 3, 2, 3) == pytest.approx(
        max(us(152 / B), us(2 * 3 * 41 / F)))


def test_t1_and_t2_bounds_at_b2_t5():
    # T1: 2 * 2 * 9 = 36 floats; 3 * 2 * 4 + 2 = 26 operations.
    assert bounds.bidiag_bound_us(2, 5) == pytest.approx(max(us(144 / B), us(26 / F)))
    # T2: 3 * 2 * 5 + 2 = 32 floats; 3 rounds: 2 * 5 * 43 = 430 operations.
    assert bounds.pcr_bound_us(2, 5) == pytest.approx(max(us(128 / B), us(430 / F)))


def test_blr_rmhmc_ops_at_n2_d2():
    # tri = 2*2*3 = 12; geometry 16 + 26 + 2 + 12 + 8 = 64; base 12 + 8 + 2 = 22; a momentum round
    # 8 + 16 + 6 = 30, two of them; u0 8; a position round 8 + 12 + 8/3 + 8; the draw and the H's 20.
    # L = 3 runs ceil(3 u) steps, 2 on average.
    flops = spec.module(spec.ROOT, "flops", "logistic_regression_rmhmc")
    cfg = {"num_data": 2, "num_features": 1}
    traffic = {"constants": {"num_leapfrog": 3, "num_fixed_point": 1}}
    assert flops.step_ops(cfg, traffic) == pytest.approx(2 * (64 + 22 + 2 * 30 + 8 + (28 + 8 / 3)) + 20)


def test_blr_mmala_ops_at_n2_d2():
    # geometry 16 + 28 + 12 + 8; curvature 12 + 8 + 2; 11 * 4.
    flops = spec.module(spec.ROOT, "flops", "logistic_regression_mmala")
    assert flops.step_ops({"num_data": 2, "num_features": 1}, {}) == pytest.approx(64 + 22 + 44)


def test_stochvol_ops_at_t10():
    rm = spec.module(spec.ROOT, "flops", "stochvol_rmhmc")
    # L_x = 3 and L_h = 1: 2 latent steps and 1 hyper step on average.
    k = {"constants": {"latent_num_leapfrog": 3, "hyper_num_leapfrog": 1}}
    assert rm.step_ops({"num_obs": 10}, k) == pytest.approx(10 * (3 + 3 + 44 + 10 + 18 + 16) + 16 * 10 * 2)
    mm = spec.module(spec.ROOT, "flops", "stochvol_mmala")
    assert mm.step_ops({"num_obs": 10}, {}) == pytest.approx(10 * (3 + 36 + 11 + 16 + 18) + 320)


def facts(ops, steps=2, shapes=None):
    trace = tr.Trace(sorted(ops, key=lambda o: o[1]), [], steps, 1e-3)
    return run.Facts(shapes or {}, 1.0, 1.0, steps, 4, 0.9, [1.0], 0.1, 1.0, trace)


def test_busy_time_counts_overlaps_once():
    assert tr.busy_us([("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 20.0, 21.0)]) == pytest.approx(13.0)


def test_roofline_reader_sums_calls():
    shapes = {"C": 4096, "D": 15}
    ops = [("void chol_inv_logdet_kernel<15>(...)", 0.0, 8.0), ("void chol_inv_logdet_kernel<15>(...)", 10.0, 16.0),
           ("gemm", 16.0, 30.0)]
    expect = 100 * 2 * bounds.bound_us("chol_inv_logdet", 4096, 15) / 14.0
    assert k3_roofline.read(facts(ops, shapes=shapes)) == pytest.approx(expect)


def test_k5_reader_pairs_the_two_kinds_of_call():
    shapes = {"C": 8, "N": 10, "D": 3, "R": 4}
    ops = [("momentum_fixed_point_kernel<3>", 0.0, 5.0), ("momentum_fixed_point_kernel<3>", 5.0, 7.0)]
    pair = sum(bounds.fixed_point_bound_us("momentum_fixed_point", 8, 10, 3, r) for r in (4, 1))
    assert k5_roofline.read(facts(ops, shapes=shapes)) == pytest.approx(100 * pair / 7.0)


def test_a_reader_with_nothing_to_read_returns_none():
    assert k3_roofline.read(facts([("gemm", 0.0, 1.0)], shapes={"C": 1, "D": 2})) is None
    assert k3_roofline.read(run.Facts({}, 1.0, 1.0, 2, 4, 0.9, [1.0], 0.1, 1.0, None)) is None


def test_trace_keeps_only_what_follows_the_traced_range():
    from types import SimpleNamespace

    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def event(name, start, end, device):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end), device_type=device)

    events = [event("warm kernel", 1.0, 5.0, cuda), event("cudaGraphLaunch", 0.5, 1.0, cpu),
              event("steps", 10.0, 40.0, cpu), event("steps", 11.0, 39.0, cuda),
              event("cudaGraphLaunch", 12.0, 13.0, cpu), event("kernel", 14.0, 20.0, cuda),
              event("kernel", 25.0, 30.0, cuda), event("after", 41.0, 42.0, cpu)]
    trace = tr.from_events(events, 3, 30e-6, since="steps")
    assert trace.ops == [("kernel", 14.0, 20.0), ("kernel", 25.0, 30.0)]
    assert trace.host == [("cudaGraphLaunch", 12.0, 13.0)]
    assert tr.busy_us(trace.ops) == pytest.approx(11.0)
