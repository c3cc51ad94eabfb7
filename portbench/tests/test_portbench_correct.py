"""The whole run but the look for a card, on the CPU at small sizes: the port agrees with the plain
reference; with the timed step broken underneath, ``correct`` comes out false; and the control, the
reference in the precision below the configuration's, reads past the cell's limits."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import calibrate, run, spec
from portbench.tests.helpers import CELLS, small_cell

CPU = torch.device("cpu")


def run_small(cell, seed=20250101, seconds=3.0, trace=False, keep=None):
    return run.run_cell(cell, seed, seconds, trace, CPU, time.perf_counter(), keep=keep)


@pytest.mark.parametrize("name", CELLS)
def test_port_agrees_with_reference(name):
    out = run_small(small_cell(name))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"min_ess_per_s", "samples_per_s", "setup_s"}


def _unchanged(before, after):
    return before


def _half(before, after):
    c = before.position.shape[0]
    keep = torch.arange(c, device=before.position.device) < c // 2
    return type(after)(*(torch.where(keep.reshape(-1, *([1] * (a.ndim - 1))), b, a) if isinstance(a, torch.Tensor)
                         else a for a, b in zip(after, before)))


def _altered(before, after):
    """A coordinate of each chain's new state moved by 1e-2, where the step produces it."""
    field = "x" if hasattr(after, "x") else "position"
    value = getattr(after, field).clone()
    value[:, 0] += 1e-2
    return after._replace(**{field: value})


FAULTS = {"unchanged": _unchanged, "half_of_chains_unchanged": _half, "answer_altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_step_is_not_correct(name, fault, monkeypatch):
    real = spec.family

    class Broken:
        def __init__(self, family):
            self.family = family

        def build(self, *args):
            system = self.family.build(*args)
            step = system.kernel.step

            def broken(generator, state):
                new, info = step(generator, state)
                return FAULTS[fault](state, new), info

            return system._replace(kernel=system.kernel._replace(step=broken))

        def reference(self, *args):
            return self.family.reference(*args)

    monkeypatch.setattr(spec, "family", lambda cell: Broken(real(cell)))
    out = run_small(small_cell(name))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    cell = small_cell(name, chains=64)
    found = calibrate.calibrate_cell(cell, [7, 8, 9], 3, 3.0, CPU, emit=lambda s: None)
    for program in found["program"]:
        assert all(program[k] <= lim for k, lim in cell.limits.items()), program
    for control in found["control"]:
        assert any(control[k] > lim for k, lim in cell.limits.items()), control


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, cuda_device):
    """On the card at the cell's own size, three seeds: the program within every limit, the control past one."""
    cell = spec.resolve(spec.load_json(run.CHECKOUT / "BENCHMARK.json"), name)
    found = calibrate.calibrate_cell(cell, [101, 102, 103], 3, 3.0, cuda_device, emit=lambda s: None)
    for program in found["program"]:
        assert all(program[k] <= lim for k, lim in cell.limits.items()), program
    for control in found["control"]:
        assert any(control[k] > lim for k, lim in cell.limits.items()), control
