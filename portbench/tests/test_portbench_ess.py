"""The frozen ESS estimator against an AR(1) series's known ESS, and its host and device forms."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.yardstick import ess


def ar1(rho: float, n: int, chains: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = np.zeros((chains, n))
    e = rng.normal(size=(chains, n))
    x[:, 0] = e[:, 0] / np.sqrt(1 - rho**2)
    for i in range(1, n):
        x[:, i] = rho * x[:, i - 1] + e[:, i]
    return x


@pytest.mark.parametrize("rho", [0.0, 0.5, 0.9])
def test_ar1_known_ess(rho):
    """ESS of AR(1) is N (1 - rho) / (1 + rho); summed over 8 chains of 20,000, within 5%."""
    x = ar1(rho, 20_000, 8, seed=3)
    total = float(ess.total_ess(lambda lo, hi: torch.from_numpy(x[lo:hi]), 8, x.shape[1], "cpu"))
    expected = 8 * 20_000 * (1 - rho) / (1 + rho)
    assert abs(total / expected - 1) < 0.05


def test_frozen_copy_matches_the_programs_exact_mode():
    """The copy gives what ``diagnostics/ess.py``'s alias-free mode gives, per chain."""
    from riemannhamiltonianmontecarlo_tpu_torch.diagnostics import ess as program_ess

    x = ar1(0.7, 3_001, 5, seed=4)
    program = np.array([program_ess.ess_geyer(row[:, None], nfft_mode="exact")[0] for row in x])
    np.testing.assert_allclose(ess.geyer_ess(torch.from_numpy(x)).numpy(), program, rtol=1e-10)


def test_blocks_of_chains_sum_as_one():
    x = torch.from_numpy(ar1(0.3, 1_000, 7, seed=5))
    whole = float(ess.geyer_ess(x).sum())
    blocked = float(ess.total_ess(lambda lo, hi: x[lo:hi], 7, 1_000, "cpu", max_bytes=1))
    assert blocked == pytest.approx(whole, rel=1e-12)


def test_a_chain_that_never_moved_has_no_ess():
    x = torch.from_numpy(ar1(0.3, 500, 2, seed=6))
    x[1] = 1.25
    out = ess.geyer_ess(x)
    assert out[1] == 0 and out[0] > 0


def test_length_changes_do_not_alias():
    """Alias-free: ESS per sample of one series moves smoothly as N crosses a power of two."""
    x = ar1(0.5, 40_000, 4, seed=7)
    per = [float(ess.geyer_ess(torch.from_numpy(x[:, :n])).sum()) / (4 * n) for n in (16_383, 16_385)]
    assert abs(per[0] / per[1] - 1) < 0.02
