"""Launch counts of the hand-written kernels and of the collectives, kept on the device.

A run shows that it went through a kernel by its count.  Each wrapper calls
``count(name, device)`` right after it launches its kernel: one more is added
to the kernel's slot of a small int64 tensor on the launch's device, on the
stream the kernel was launched on.  That addition is a device op, so when the
call is captured into a CUDA graph (``parallel.graphs``) it is recorded with
the kernel and runs at every replay: the count is of the launches the device
made, eager or replayed, and nothing credits launches that no one saw.
``parallel.collectives`` counts each all-reduce it issues the same way, on
the reduced tensor's device (``collectives.call_counts``).

``paused()`` stops counting inside it: the runner's warm-up steps before a
capture, and a check that launches a kernel to compare it with its plain
version, are not launches of the run.  ``counts()`` reads every device's
counts (it waits for the devices); ``reset()`` zeroes them in place, so a
graph captured earlier goes on adding to the same memory.
"""

from __future__ import annotations

import contextlib

import torch
from torch import Tensor

# The counted kernels: ops.hopper_linalg's K1, K2 and K3, ops.tridiag's bidiagonal scan T1 and PCR solve
# T2 (each of its launches: one a call up to tridiag.PCR_SHARED_MAX_T positions), ops.fhn_sens's kernel by
# order, the Gibbs sweep (samplers.gibbs), the whole GIG draw and one GIG rejection round from given draws
# (ops.gig), BLR RMHMC's position and momentum fixed points K4 and K5 (ops.logreg_fixed_point); the
# all-reduces of parallel.collectives.
NAMES = ("cholesky", "chol_solve_logdet", "chol_inv_logdet", "bidiag_cholesky", "pcr_solve", "fhn_sensitivities/0",
         "fhn_sensitivities/1", "fhn_sensitivities/2", "gibbs_sweep", "gig_half", "gig_round",
         "position_fixed_point", "momentum_fixed_point", "all_reduce")
_SLOT = {name: i for i, name in enumerate(NAMES)}
_COUNTS: dict[torch.device, Tensor] = {}
_PAUSED = [0]


def _counter(device: torch.device) -> Tensor:
    if device not in _COUNTS:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"a kernel's first launch on {device} is inside a CUDA graph capture: "
                               "its launch counter would live in the graph's memory pool")
        # A normal tensor, so that it can be added to inside and outside inference mode.
        with torch.inference_mode(False):
            _COUNTS[device] = torch.zeros((len(NAMES),), dtype=torch.int64, device=device)
    return _COUNTS[device]


def count(name: str, device: torch.device) -> None:
    """One launch of kernel ``name`` on ``device``, added on the current stream."""
    counter = _counter(device)
    if not _PAUSED[0]:
        with torch.inference_mode(False), torch.no_grad():
            counter[_SLOT[name]].add_(1)


def counts(names=NAMES) -> dict[str, int]:
    """The launches of ``names`` counted on every device since the last reset."""
    total = dict.fromkeys(names, 0)
    for device, counter in _COUNTS.items():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        for name, n in zip(NAMES, counter.tolist()):
            if name in total:
                total[name] += n
    return total


def reset(names=NAMES) -> None:
    """Zero the counts of ``names`` on every device."""
    for counter in _COUNTS.values():
        with torch.inference_mode(False), torch.no_grad():
            for name in names:
                counter[_SLOT[name]].zero_()


@contextlib.contextmanager
def paused():
    """Launches inside are not counted."""
    _PAUSED[0] += 1
    try:
        yield
    finally:
        _PAUSED[0] -= 1
