"""The FitzHugh-Nagumo kernel's launch geometry and lane layout, on the CPU.

``ops/fhn_sens.py`` mirrors how ``csrc/fhn_sens.cu`` lays chains out on the
card (``launch_geometry``) and which lane of a chain's group writes which
output entry (``lane_outputs``); ``chip_smoke.py`` holds both against the
built library on the card.  Here: the geometry covers every chain once
with its lanes inside one warp, the table gives every entry one lane that
holds what the entry needs, and the kernel's per-lane sums, put together as
the table says, give the twin's outputs (float64, so only the order of the
sums differs).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from riemannhamiltonianmontecarlo_tpu_torch.models import fhn
from riemannhamiltonianmontecarlo_tpu_torch.ops import fhn_sens

CHAINS = (1, 31, 256, 257, 4224)
WARP = 32


@pytest.mark.parametrize("num_chains", CHAINS)
@pytest.mark.parametrize("order", fhn_sens.ORDERS)
def test_torch_fhn_geometry_covers_every_chain_once(order, num_chains):
    geo = fhn_sens.launch_geometry(order, num_chains, 200)
    assert geo.threads_per_block == geo.lanes_per_chain * geo.chains_per_block
    assert (geo.blocks - 1) * geo.chains_per_block < num_chains <= geo.blocks * geo.chains_per_block
    thread = np.arange(geo.blocks * geo.threads_per_block)  # global thread index
    chain = thread // geo.lanes_per_chain
    live = chain < num_chains
    assert np.array_equal(np.bincount(chain[live], minlength=num_chains), np.full(num_chains, geo.lanes_per_chain))
    # a chain's lanes are one aligned slice of one warp: the same warp, the same block
    lanes = geo.lanes_per_chain
    for unit in (WARP, geo.threads_per_block):
        assert np.array_equal(thread[::lanes] // unit, thread[lanes - 1::lanes] // unit)


@pytest.mark.parametrize("order", fhn_sens.ORDERS)
def test_torch_fhn_geometry_lanes_and_shared_memory(order):
    geo = fhn_sens.launch_geometry(order, 256, 200)
    lanes = geo.lanes_per_chain
    assert lanes & (lanes - 1) == 0 and WARP % lanes == 0  # a power of two: a fixed slice of a warp
    assert fhn_sens.WORKING_LANES[order] <= lanes
    assert geo.shared_bytes == 4 * 2 * 200  # the whole series, within one tile
    if order == 0:
        assert lanes == 1 and geo.chains_per_block == geo.threads_per_block


@pytest.mark.parametrize("args", [(3, 256, 200), (1, 0, 200), (1, 256, 1)])
def test_torch_fhn_geometry_refuses_what_the_kernel_refuses(args):
    with pytest.raises(ValueError):
        fhn_sens.launch_geometry(*args)


@pytest.mark.parametrize("num_obs", [6145, 50000])
@pytest.mark.parametrize("order", fhn_sens.ORDERS)
def test_torch_fhn_geometry_takes_any_number_of_observations(order, num_obs):
    """Past the 6,144 observations that the first form staged in 48 KB (the
    data then streams from device memory): the same lanes and blocks as at
    200, and a block's shared memory bounded and independent of num_obs."""
    geo, short = fhn_sens.launch_geometry(order, 256, num_obs), fhn_sens.launch_geometry(order, 256, 200)
    assert geo._replace(shared_bytes=0) == short._replace(shared_bytes=0)
    staged = fhn_sens.launch_geometry(order, 256, fhn_sens.STAGED_MAX_OBS).shared_bytes
    assert geo.shared_bytes == 0 and staged == 4 * 2 * fhn_sens.STAGED_MAX_OBS <= 48 * 1024
    assert geo.shared_bytes == fhn_sens.launch_geometry(order, 256, 2 * num_obs).shared_bytes


@pytest.mark.parametrize("order", fhn_sens.ORDERS)
def test_torch_fhn_every_output_entry_has_one_lane(order):
    lanes = fhn_sens.lane_outputs(order)
    assert len(lanes) == fhn_sens.LANES_PER_CHAIN[order]
    written = [e for entries in lanes for e in entries]
    names = [fhn_sens.ENTRIES[e][0] for e in written]
    expected = {"logp": 1, "grad": 3, "G": 9, "dG": 27}
    outputs = ["logp", "grad", "G", "dG"][: 1 if order == 0 else 3 if order == 1 else 4]
    assert sorted(written) == sorted(set(written))  # no entry written twice
    assert {name: names.count(name) for name in outputs} == {name: expected[name] for name in outputs}
    assert set(names) == set(outputs)
    assert all(not entries for entries in lanes[fhn_sens.WORKING_LANES[order]:])  # spare lanes write nothing
    owners = fhn_sens.output_owners(order)
    assert all(owners[e] == lane for lane, entries in enumerate(lanes) for e in entries)
    assert sum(o >= 0 for o in owners) == len(written)


@pytest.mark.parametrize("order", (1, 2))
def test_torch_fhn_lanes_write_what_they_integrate(order):
    """Order 1: lane j integrates S_j, so it writes grad[j] and entries of G
    in row or column j.  Order 2: lane p integrates S_i, S_j and T_ij, (i, j)
    = PAIRS[p], so it writes G and dG[k] at (i, j) and grad[i] only where
    i == j."""
    for lane, entries in enumerate(fhn_sens.lane_outputs(order)):
        for e in entries:
            name, *idx = fhn_sens.ENTRIES[e]
            if name == "logp":
                assert lane == 0
            elif order == 1:
                assert lane == idx[0] if name == "grad" else lane in idx
            elif name == "grad":
                assert fhn_sens.PAIRS[lane] == (idx[0], idx[0])
            else:
                assert fhn_sens.PAIRS[lane] == tuple(sorted(idx[-2:]))


def lane_layout(theta, data, order, substeps, noise_sd, gamma_scale):
    """The kernel's lane layout in plain PyTorch: the twin's augmented RK4,
    each lane's running sums as ``csrc/fhn_sens.cu`` keeps them (order 1,
    lane j: e.S_j, S_j.S_j, S_j.S_j+1; order 2, lane (i, j): e.S_i, S_i.S_j
    and T_ij.S_c for each c), and each output entry put together from them
    by the lane that ``lane_outputs`` names.  Entries nobody writes stay NaN."""
    cn, num_obs, var = theta.shape[0], data.shape[0], noise_sd**2
    h = fhn_sens.step_size(num_obs, substeps)
    a, b, c = theta[:, 0:1], theta[:, 1:2], theta[:, 2:3]
    inv_c = 1.0 / c
    th = (a, b, c, inv_c, inv_c * inv_c, inv_c**3, b * inv_c)
    y = torch.zeros((cn, 20), dtype=theta.dtype)
    y[:, 0], y[:, 1] = fhn_sens.INIT
    pairs = fhn_sens.PAIRS
    sq = torch.zeros(cn, dtype=theta.dtype)
    grad_s, g_s, g_next = (torch.zeros((cn, 6), dtype=theta.dtype) for _ in range(3))
    part = torch.zeros((cn, 6, 3), dtype=theta.dtype)
    for t in range(num_obs):
        if t > 0:
            for _ in range(substeps):
                k1 = fhn_sens._rhs(2, th, y)
                k2 = fhn_sens._rhs(2, th, y + 0.5 * h * k1)
                k3 = fhn_sens._rhs(2, th, y + 0.5 * h * k2)
                k4 = fhn_sens._rhs(2, th, y + h * k3)
                y = y + h / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        err = data[t] - y[:, :2]  # (C, species)
        s, tt = y[:, 2:8].reshape(cn, 2, 3), y[:, 8:20].reshape(cn, 2, 6)  # [species, column], [species, pair]
        sq = sq + (err * err).sum(1)
        for lane in range(fhn_sens.WORKING_LANES[order]):
            i, j = (lane, (lane + 1) % 3) if order == 1 else pairs[lane]
            grad_s[:, lane] += (err * s[:, :, i]).sum(1)
            g_s[:, lane] += (s[:, :, i] * s[:, :, lane if order == 1 else j]).sum(1)
            g_next[:, lane] += (s[:, :, i] * s[:, :, j]).sum(1)
            part[:, lane] += (tt[:, :, lane : lane + 1] * s).sum(1)
    valid = (theta > 0).all(1) & torch.isfinite(y[:, :2]).all(1)
    out = torch.full((cn, len(fhn_sens.ENTRIES)), torch.nan, dtype=theta.dtype)
    for lane, entries in enumerate(fhn_sens.lane_outputs(order)):
        for e in entries:
            name, *idx = fhn_sens.ENTRIES[e]
            if name == "logp":
                value = torch.where(valid, -0.5 * sq / var - theta.sum(1) / gamma_scale, -torch.inf)
            elif name == "grad":
                value = grad_s[:, lane] / var - 1.0 / gamma_scale
                value = torch.where(valid & torch.isfinite(value), value, 0.0)
            elif name == "G":
                i, j = idx
                value = (g_s[:, lane] if order == 2 or i == j else g_next[:, lane]) / var
                value = value + (2.0 / theta[:, i] ** 2 if i == j else 0.0)
            else:  # dG[k][i][j] = sum T_ik S_j + sum T_jk S_i
                k, i, j = idx
                value = (part[:, fhn_sens.PAIR_OF[i][k], j] + part[:, fhn_sens.PAIR_OF[j][k], i]) / var
                value = value + (-4.0 / theta[:, k] ** 3 if i == j == k else 0.0)
            out[:, e] = value
    return out


@pytest.mark.parametrize("order", (0, 1, 2))
def test_torch_fhn_lane_layout_gives_the_twins_outputs(order):
    rng = np.random.default_rng(9)
    data, _ = fhn.generate_data(seed=1, num_obs=30)
    data = torch.tensor(data, dtype=torch.float64)
    theta = torch.tensor(np.asarray(fhn.THETA_TRUE) * (1 + 0.1 * rng.standard_normal((5, 3))))
    theta[3] = torch.tensor((-0.1, 0.2, 3.0), dtype=torch.float64)  # outside the support
    consts = dict(substeps=3, noise_sd=0.5, gamma_scale=3.0)
    got = lane_layout(theta, data, order, **consts)
    want = fhn_sens.fhn_sensitivities_plain(theta, data, order, **consts)
    flat = torch.cat([t.reshape(5, -1) for t in want if t is not None], 1)
    width = flat.shape[1]
    assert not torch.isnan(got[:, :width]).any() and torch.isnan(got[:, width:]).all()
    torch.testing.assert_close(got[:, :width], flat, rtol=1e-10, atol=1e-10)


def test_torch_fhn_critical_path():
    # 995 steps of 25 dependent operations, then one observation's 3, at 4 cycles and 1,980 MHz
    assert fhn_sens.dependent_operations(200, 5) == 995 * 25 + 3
    assert fhn_sens.critical_path_us(200, 5, 1980.0) == pytest.approx((995 * 25 + 3) * 4 / 1980.0)
    assert fhn_sens.critical_path_us(200, 5, 1980.0) == fhn_sens.critical_path_us(200, 5, 1980.0 / 2) / 2
