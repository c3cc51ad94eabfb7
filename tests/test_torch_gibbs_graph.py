"""Port: the Gibbs step as a fixed sequence of launches, on the CPU.

On a card a Gibbs step is K1 twice, the sweep kernel G1 once and the GIG
kernel G2 once, with no read of the device, so the runner replays it as a
CUDA graph.  Here the kernels' plain versions run, and these tests hold
what makes that so:

* Philox4x32-10, the GIG's counter-based generator, gives Random123's
  known answers;
* ``sample_gig_half`` draws exactly one key from the generator and returns,
  bit for bit, the ``lam`` of the early-exit loop that the port ran before
  (``parent_sample_gig_half`` below, a copy kept as the reference) fed the
  same counter draws, at r^2 in {1e-4, 1, 25} and on a mixed batch; the
  rows of a chain split are one process's rows, bit for bit;
* ``gig_round_plain`` is one round of that loop, in place: elements already
  accepted keep their lambda;
* ``gibbs.sweep`` on the CPU is ``gibbs_sweep_plain`` (held against the
  JAX package's sweep in ``tests/test_torch_gibbs.py``), and G1's
  look-ahead algebra (p_{j+1} = B_j x_{j+1} + delta_j S_j x_{j+1}) in
  float64 is the plain sweep;
* one Gibbs step (and its monitored kernel's) reads nothing on the host:
  ``Tensor.__bool__``, ``.item`` and ``.tolist`` patched to raise (the
  parent's loop does raise under the patch);
* the kernels' wrappers refuse a CPU tensor, and G1's a D outside 1..48.

The graph itself (``StepGraph.body`` against the eager loop) is held in
``tests/test_torch_graphs.py``; the kernels against these plain versions on
the card in ``chip_smoke.py`` phase 3.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import riemannhamiltonianmontecarlo_tpu_torch as rt
from riemannhamiltonianmontecarlo_tpu_torch.ops import gig, truncnorm
from riemannhamiltonianmontecarlo_tpu_torch.samplers import gibbs
from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import ChainRows

torch.set_num_threads(1)

# -- the early-exit loop this port ran before G2 (its own copy: the reference) --


def _parent_run_squeeze(body, u, active, max_bodies):
    z = torch.ones_like(u)
    decided = ~active
    accept = torch.zeros_like(decided)
    j = 1.0
    bodies = 0
    while bodies < max_bodies and not bool(decided.all()):
        for _ in range(min(2, max_bodies - bodies)):
            z_new, acc_now, rej_now = body(z, j)
            accept = accept | (~decided & acc_now)
            z = torch.where(decided, z, z_new)
            decided = decided | acc_now | rej_now
            j += 2
            bodies += 1
    return decided, accept


def _parent_rightmost(u, lam, active, max_bodies):
    x_log = -0.5 * lam

    def body(z, j):
        n1 = j + 1.0
        z_sub = z - n1**2 * torch.exp(x_log * (n1**2 - 1.0))
        n2 = j + 2.0
        z_add = z_sub + n2**2 * torch.exp(x_log * (n2**2 - 1.0))
        return z_add, z_sub > u, z_add < u

    return _parent_run_squeeze(body, u, active, max_bodies)


def _parent_leftmost(u, lam, active, max_bodies):
    pi2 = math.pi**2
    lam_safe = torch.clamp(lam, min=1e-20)
    h = 0.5 * math.log(2.0) + 2.5 * math.log(math.pi) - 2.5 * torch.log(lam_safe) - pi2 / (2.0 * lam_safe) + 0.5 * lam_safe
    log_u = torch.log(u)
    x_log = -pi2 / (2.0 * lam_safe)
    k = lam_safe / pi2

    def safe_log(z):
        return torch.where(z > 0.0, torch.log(torch.clamp(z, min=1e-300)), -math.inf)

    def body(z, j):
        z_sub = z - k * torch.exp(x_log * (j**2 - 1.0))
        n2 = j + 2.0
        z_add = z_sub + n2**2 * torch.exp(x_log * (n2**2 - 1.0))
        return z_add, h + safe_log(z_sub) > log_u, h + safe_log(z_add) < log_u

    return _parent_run_squeeze(body, u, active, max_bodies)


def counter_draws(key: int, shape):
    """Round k's normal, u_side and u of every element: the Philox words of
    (flat index, k) under ``key``, as ``sample_gig_half`` draws them."""
    index = torch.arange(math.prod(shape))

    def draw(k):
        return [d[0].reshape(shape) for d in gig.round_draws(torch.tensor(key), index, torch.tensor([k]))]

    return draw


def parent_sample_gig_half(draw, r2, max_rejection_rounds=64, max_series_bodies=32):
    """The port's early-exit GIG loop before its kernel, fed round k's draws by ``draw(k)``."""
    r = torch.sqrt(torch.clamp(r2, min=1e-16))
    lam = torch.ones_like(r)
    ok = torch.zeros(r.shape, dtype=torch.bool)
    tries = 0
    while tries < max_rejection_rounds:
        for _ in range(min(4, max_rejection_rounds - tries)):
            normal, u_side, u = draw(tries)
            y0 = normal**2
            root = y0 + torch.sqrt(y0 * (y0 + 4.0 * r))
            y = 4.0 * r * y0 / torch.clamp(root * root, min=1e-30)
            lam_cand = torch.clamp(torch.where(u_side <= 1.0 / (1.0 + y), r / y, r * y), min=1e-12)
            right = lam_cand > 4.0 / 3.0
            dec_r, acc_r = _parent_rightmost(u, lam_cand, ~ok & right, max_series_bodies)
            dec_l, acc_l = _parent_leftmost(u, lam_cand, ~ok & ~right, max_series_bodies)
            accept = torch.where(right, dec_r & acc_r, dec_l & acc_l) & torch.isfinite(lam_cand)
            lam = torch.where(~ok & accept, lam_cand, lam)
            ok = ok | accept
            tries += 1
        if bool(ok.all()):
            break
    return lam


def r2_batch(case: str) -> torch.Tensor:
    if case == "mixed":  # r^2 log-uniform over [1e-4, 25]: both series, every regime
        gen = torch.Generator().manual_seed(11)
        return torch.exp(torch.empty((32, 60)).uniform_(math.log(1e-4), math.log(25.0), generator=gen))
    return torch.full((32, 60), float(case))


R2_CASES = ["1e-4", "1.0", "25.0", "mixed"]


def call_key(seed: int) -> int:
    """The key ``sample_gig_half`` draws from a generator seeded with ``seed``."""
    return int(torch.randint(*gig.KEY_RANGE, (1,), generator=torch.Generator().manual_seed(seed)))


# Random123's known answers for philox4x32-10: key (k0, k1), counter (c0..c3) -> the four output words.
PHILOX_KAT = [
    ((0x0, 0x0), (0x0, 0x0, 0x0, 0x0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 4, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0xA4093822, 0x299F31D0), (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("key, counter, want", PHILOX_KAT, ids=["zeros", "ones", "pi"])
def test_torch_gig_philox_known_answers(key, counter, want):
    words = gig.philox4x32(tuple(torch.tensor([c]) for c in counter), tuple(torch.tensor(k) for k in key))
    assert [int(w) for w in words] == list(want)
    assert all(w.dtype == torch.int64 for w in words)


def test_torch_gig_uniforms_and_normal_of_the_words():
    """A word's top 23 bits k give (2k + 1) 2^-24 exactly, never 0 or 1; the
    draws of a round are Box-Muller's normal of words 0 and 1 and the
    uniforms of words 2 and 3."""
    words = torch.tensor([0, 511, 512, 0xFFFFFFFF, 0x80000000])
    u = gig.unit_uniform(words)
    assert u.dtype == torch.float32
    assert u.tolist() == [2.0**-24, 2.0**-24, 3 * 2.0**-24, 1.0 - 2.0**-24, 0.5 + 2.0**-24]
    key, index, rounds = torch.tensor(-12345678901), torch.tensor([0, 7, 2**33 + 5]), torch.tensor([0, 3])
    normal, u_side, u_acc = gig.round_draws(key, index, rounds)
    w = gig.philox4x32((index & 0xFFFFFFFF, index >> 32, rounds[:, None], torch.zeros_like(index)),
                       (key & 0xFFFFFFFF, (key >> 32) & 0xFFFFFFFF))
    assert torch.equal(normal, gig.box_muller(gig.unit_uniform(w[0]), gig.unit_uniform(w[1])))
    assert torch.equal(u_side, gig.unit_uniform(w[2])) and torch.equal(u_acc, gig.unit_uniform(w[3]))
    assert normal.shape == (2, 3) and not torch.equal(normal[0], normal[1])


@pytest.mark.parametrize("case", R2_CASES)
def test_torch_gig_fixed_rounds_return_the_early_exit_loops_lambda(case):
    r2 = r2_batch(case)
    fixed = gig.sample_gig_half(torch.Generator().manual_seed(7), r2)
    early = parent_sample_gig_half(counter_draws(call_key(7), r2.shape), r2)
    assert torch.isfinite(fixed).all() and (fixed > 0).all()
    assert torch.equal(fixed, early)


def test_torch_gig_fixed_rounds_draw_exactly_the_cap():
    """A call draws exactly one key from the generator, whatever was decided
    and however many rounds its elements ran (up to 21 here)."""
    r2 = r2_batch("mixed")
    gen = torch.Generator().manual_seed(3)
    gig.sample_gig_half(gen, r2, max_rejection_rounds=64)
    ref = torch.Generator().manual_seed(3)
    torch.randint(*gig.KEY_RANGE, (1,), generator=ref)
    assert torch.equal(gen.get_state(), ref.get_state())
    ran = gig.gig_half_plain_rounds(torch.sqrt(r2), torch.tensor([call_key(3)]))[1]
    assert int(ran.min()) == 1 and int(ran.max()) > 8  # elements ran different numbers of rounds


def test_torch_gig_rank_rows_are_one_process_rows():
    """Under a chain split a rank's rows of lambda are, bit for bit, those
    rows of one process's call from the same generator state."""
    r2 = r2_batch("mixed")
    whole = gig.sample_gig_half(torch.Generator().manual_seed(9), r2)
    for lo, hi in ((0, 11), (11, 32), (5, 6)):
        rows = ChainRows(lo, hi, r2.shape[0])
        part = gig.sample_gig_half(gig.GigDraws(torch.Generator().manual_seed(9), rows), r2[lo:hi])
        assert torch.equal(part, whole[lo:hi])
    assert not torch.equal(gig.sample_gig_half(torch.Generator().manual_seed(9), r2[11:32]), whole[11:32])


def test_torch_gig_round_plain_updates_in_place_and_keeps_the_accepted():
    gen = torch.Generator().manual_seed(5)
    r = torch.sqrt(r2_batch("mixed"))
    draws = [torch.randn(r.shape, generator=gen), torch.rand(r.shape, generator=gen), torch.rand(r.shape, generator=gen)]
    lam, ok = torch.ones_like(r), torch.zeros(r.shape, dtype=torch.bool)
    lam_ptr, ok_ptr = lam.data_ptr(), ok.data_ptr()
    gig.gig_round_plain(r, *draws, lam, ok)
    assert lam.data_ptr() == lam_ptr and ok.data_ptr() == ok_ptr
    assert 0 < int(ok.sum()) < ok.numel()  # some accepted, some not, in one round
    assert torch.equal(lam[~ok], torch.ones_like(lam[~ok]))
    kept_lam, kept_ok = lam.clone(), ok.clone()
    again = [torch.randn(r.shape, generator=gen), torch.rand(r.shape, generator=gen), torch.rand(r.shape, generator=gen)]
    gig.gig_round_plain(r, *again, lam, ok)
    assert torch.equal(lam[kept_ok], kept_lam[kept_ok]) and bool(ok[kept_ok].all())


@pytest.mark.parametrize("wrapper", ["gig_round_cuda", "gibbs_sweep_cuda", "sample_gig_half_cuda"])
def test_torch_gibbs_kernel_wrappers_refuse_cpu_tensors(wrapper):
    r = torch.ones((4, 6))
    with pytest.raises(ValueError, match="CUDA"):
        if wrapper == "gig_round_cuda":
            gig.gig_round_cuda(r, r, r, r, r.clone(), torch.zeros(r.shape, dtype=torch.bool))
        elif wrapper == "sample_gig_half_cuda":
            gig.sample_gig_half_cuda(r, torch.zeros(1, dtype=torch.int64))
        else:
            c, n, d = 4, 6, 3
            noise = truncnorm.draw_noise(torch.Generator().manual_seed(0), (n, c))
            gibbs.gibbs_sweep_cuda(torch.ones((n, d)), torch.ones(n), r, r, r, torch.ones((c, d, n)),
                                   torch.ones((c, d)), noise)


@pytest.fixture(scope="module")
def gibbs_setup():
    ds = rt.models.synthetic_logreg(seed=9, n=60, d=5)
    model = rt.interop.logreg_from_numpy(ds.X, ds.t, device="cpu")
    kernel = gibbs.build(model)
    with torch.inference_mode():
        state = kernel.step(torch.Generator().manual_seed(1), kernel.init(torch.zeros((16, 5))))[0]  # lambda != 1
    return model, kernel, state


def test_torch_gibbs_sweep_plain_is_the_sweep_on_the_cpu(gibbs_setup):
    model, _, state = gibbs_setup
    c, n = state.z.shape
    with torch.inference_mode():
        cond = gibbs.conditionals(model, state)
        noise = truncnorm.draw_noise(torch.Generator().manual_seed(2), (n, c))
        swept = gibbs.sweep(model, state, cond, noise)
        plain = gibbs.gibbs_sweep_plain(model.X, model.t, state.lam, cond.h, state.z, cond.s, cond.b, noise)
    assert torch.equal(swept[0], plain[0]) and torch.equal(swept[1], plain[1])
    positive = (model.t == 1.0).expand(c, n)
    assert bool((swept[1][positive] > 0).all()) and bool((swept[1][~positive] < 0).all())


def _raise(*args, **kwargs):
    raise RuntimeError("the step read the device")


@pytest.fixture
def no_host_reads(monkeypatch):
    for name in ("__bool__", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, _raise)


@pytest.mark.parametrize("monitored", [False, True], ids=["gibbs", "monitor-of-gibbs"])
def test_torch_gibbs_step_reads_nothing_on_the_host(gibbs_setup, monitored, request):
    model, kernel, state = gibbs_setup
    if monitored:
        kernel = rt.parallel.monitor(kernel, every=1000)
    assert kernel.capturable
    with torch.inference_mode():
        start = kernel.init(state.position) if monitored else state
        request.getfixturevalue("no_host_reads")
        out, info = kernel.step(torch.Generator().manual_seed(4), start)
        with pytest.raises(RuntimeError, match="read the device"):  # the patch bites: the parent's loop is caught
            parent_sample_gig_half(counter_draws(0, (4,)), torch.ones(4))
    out_state = out.inner if monitored else out
    assert out_state.z.shape == state.z.shape and out_state.lam.shape == state.lam.shape
    assert np.isfinite(out_state.position.numpy()).all() and np.isfinite(out_state.lam.numpy()).all()


def test_torch_gibbs_capturable_where_its_model_is(gibbs_setup, monkeypatch):
    """On a row-split model, where the group's all-reduces may be captured: NCCL, not Gloo."""
    model, kernel, _ = gibbs_setup
    assert kernel.capturable and rt.parallel.monitor(kernel, every=10).capturable
    mesh = rt.parallel.Mesh(("data",), {"data": 1}, {"data": 0}, {"data": "group"})  # a stand-in group
    for backend in ("gloo", "nccl"):
        monkeypatch.setattr(torch.distributed, "get_backend", lambda group=None, b=backend: b)
        assert gibbs.build(model.with_sharding(mesh, "data")).capturable == (backend == "nccl")


@pytest.mark.parametrize("dim", [0, 49, 2049])
def test_torch_gibbs_sweep_kernel_refuses_no_width_but_zero(dim):
    """G1 takes any D >= 1 (B in registers on a warp to 32 x SWEEP_ENT_MAX entries, on a block of
    warps past that): its wrapper refuses D = 0 before it looks at the
    device, and goes on to refuse a CPU tensor at D = 49 and 2049, past K1's 48."""
    c, n = 4, 6
    noise = truncnorm.draw_noise(torch.Generator().manual_seed(0), (n, c))
    r = torch.ones((c, n))
    args = (torch.ones((n, dim)), torch.ones(n), r, r, r, torch.ones((c, dim, n)), torch.ones((c, dim)), noise)
    match = "D >= 1, got D = 0" if dim == 0 else "CUDA device"
    with pytest.raises(ValueError, match=match):
        gibbs.gibbs_sweep_cuda(*args)


def lookahead_sweep(x, t, lam, h, z_old, s, b, noise, lanes):
    """G1's algorithm (csrc/gibbs.cu::gibbs_sweep_kernel) in float64: lane l of
    a chain's group holds B's entries l, l + lanes, ...; with p_0 = B_0 x_0,
    step j's chain reads p_j, while the group sums R = B_j x_{j+1} and
    Q = S[:, j] x_{j+1} over its lanes' partial sums; then
    p_{j+1} = R + delta_j Q and B += delta_j S[:, j]."""
    n, d = x.shape
    owner = [list(range(lane, d, lanes)) for lane in range(lanes)]  # the entries of each lane
    w = h / torch.clamp(lam - h, min=1e-12)
    sd = torch.sqrt(lam * (w + 1.0))
    signed = torch.where(t == 1.0, sd, -sd)
    terms = truncnorm.prepare(noise)
    b = b.clone()

    def group_dot(u, j_next):  # each lane's partial sum over its entries, then the group's sum
        return sum((u[:, e] * x[j_next, e]).sum(dim=1) for e in owner)

    p = group_dot(b, 0)
    z = torch.empty_like(z_old)
    for j in range(n):
        jn = min(j + 1, n - 1)
        r_sum, q_sum = group_dot(b, jn), group_dot(s[:, :, j], jn)
        m = (1.0 + w[:, j]) * p - w[:, j] * z_old[:, j]
        a = -m / signed[:, j]
        z_std = truncnorm.std_truncnorm_above(a, truncnorm.TailTerms(*(u[..., j, :] for u in terms)))
        z[:, j] = m + signed[:, j] * z_std
        delta = (z[:, j] - z_old[:, j]) / lam[:, j]
        b = b + delta[:, None] * s[:, :, j]
        p = r_sum + delta * q_sum
    return b, z


def butterfly_sum(parts):
    """A warp's sum over its lanes as ``group_sum`` takes it: at offsets 1, 2, 4, ... each lane adds the
    partner lane's sum (lane ^ offset), so every lane ends with the same sum; lane 0's is returned."""
    parts = list(parts)
    off = 1
    while off < len(parts):
        parts = [parts[lane] + parts[lane ^ off] for lane in range(len(parts))]
        off *= 2
    return parts[0]


def block_sweep(x, t, lam, h, z_old, s, b, noise, warps, lanes, memory):
    """G1's wide layout in float64, with ``lanes`` lanes a warp in place of 32: thread th = warp x lanes +
    lane owns B's entries th, th + warps x lanes, ...; each thread sums its terms in the order of its
    entries, a warp's lanes meet as ``butterfly_sum``, and the warps' sums are added in warp order.  With
    p_0 = B_0 x_0, step j's chain reads p_j, while the block sums R_j = B_j x_{j+1} and Q_j = S[:, j] x_{j+1};
    then p_{j+1} = R_j + delta_j Q_j.  B += delta_j S[:, j] after the chain (csrc/gibbs.cu::
    gibbs_sweep_block_kernel, B in registers), or (``memory``: gibbs_sweep_memory_kernel) in the pass
    before step j + 1's sums, and once after the last step."""
    n, d = x.shape
    threads = warps * lanes
    owned = [list(range(th, d, threads)) for th in range(threads)]
    w = h / torch.clamp(lam - h, min=1e-12)
    sd = torch.sqrt(lam * (w + 1.0))
    signed = torch.where(t == 1.0, sd, -sd)
    terms = truncnorm.prepare(noise)
    b = b.clone()

    def block_dot(u, row):
        thread_parts = [sum((u[:, e] * row[e] for e in entries), torch.zeros(u.shape[0], dtype=u.dtype))
                        for entries in owned]
        warp_sums = [butterfly_sum(thread_parts[wp * lanes:(wp + 1) * lanes]) for wp in range(warps)]
        return sum(warp_sums[1:], warp_sums[0])

    p = block_dot(b, x[0])
    z = torch.empty_like(z_old)
    delta = None
    for j in range(n):
        jn = min(j + 1, n - 1)
        if memory and delta is not None:
            b = b + delta[:, None] * s[:, :, j - 1]
        r_sum, q_sum = block_dot(b, x[jn]), block_dot(s[:, :, j], x[jn])
        m = (1.0 + w[:, j]) * p - w[:, j] * z_old[:, j]
        z_std = truncnorm.std_truncnorm_above(-m / signed[:, j], truncnorm.TailTerms(*(u[..., j, :] for u in terms)))
        z[:, j] = m + signed[:, j] * z_std
        delta = (z[:, j] - z_old[:, j]) / lam[:, j]
        if not memory:
            b = b + delta[:, None] * s[:, :, j]
        p = r_sum + delta * q_sum
    if memory:
        b = b + delta[:, None] * s[:, :, n - 1]
    return b, z


WIDE_CASES = {"wide-2": (3, 2, False), "wide-32": (1, 32, False), "wide-2x2-memory": (2, 2, True),
              "wide-3x1-memory": (3, 1, True)}  # (warps, lanes a warp, B in memory) at D = 5


@pytest.mark.parametrize("layout", ["1", "4", "8", *WIDE_CASES])
def test_torch_gibbs_sweep_lookahead_algebra_is_the_sweep(gibbs_setup, layout):
    """The look-ahead dot of G1, in float64, gives the plain sweep's B and z
    (float64) to 1e-9: the reordering changes only the rounding.  So does
    the wide layout's block of warps, B in registers or updated in memory
    before each step's sums (D = 5 over 3 warps of 2 lanes: ragged, the last
    warp half empty; 2 x 2 and 3 x 1: a thread owning two entries)."""
    model, _, state = gibbs_setup
    c, n = state.z.shape
    state64 = gibbs.GibbsState(*(a.double() for a in state))
    with torch.inference_mode():
        cond = gibbs.conditionals(model, state)
        noise = truncnorm.draw_noise(torch.Generator().manual_seed(6), (n, c), dtype=torch.float64)
        x, t = model.X.double(), model.t.double()
        args = (x, t, state64.lam, cond.h.double(), state64.z, cond.s.double(), cond.b.double(), noise)
        bp, zp = gibbs.gibbs_sweep_plain(*args)
        if layout in WIDE_CASES:
            warps, lanes, memory = WIDE_CASES[layout]
            bl, zl = block_sweep(*args, warps=warps, lanes=lanes, memory=memory)
        else:
            bl, zl = lookahead_sweep(*args, lanes=int(layout))
    assert bp.dtype == torch.float64
    torch.testing.assert_close(zl, zp, rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(bl, bp, rtol=1e-9, atol=1e-9)


def test_torch_gibbs_block_sweep_sums_in_the_kernels_order():
    """The mirror's sums run in the kernel's order: on values where float64 addition is not associative,
    the butterfly over a warp's lanes and the warps' sums added in order give the kernel's bits, which a
    plain left-to-right sum over the threads does not."""
    parts = [1e16, 1.0, -1e16, 1.0]
    assert butterfly_sum(parts) == (1e16 + 1.0) + (-1e16 + 1.0)
    assert butterfly_sum(parts) != sum(parts)


@pytest.mark.parametrize("chains", [1, 31, 1024, 1057, 4224, 8448, 40000])
def test_torch_gibbs_sweep_layout(chains):
    """G1's lanes a chain: the most of the kernel's lane counts that keep its
    warps within two a scheduler (8 an SM), one past that; its scratch only
    where a chain takes a whole warp (csrc/gibbs.cu)."""
    budget = gibbs.SWEEP_WARPS_PER_SM * gibbs.H100_SMS * gibbs.SWEEP_THREADS
    lanes = gibbs.sweep_lanes(chains)
    assert lanes in gibbs.SWEEP_LANES
    assert lanes == 1 or lanes * chains <= budget
    assert lanes == gibbs.SWEEP_THREADS or 2 * lanes * chains > budget
    assert gibbs.sweep_lanes(chains, sm_count=2 * gibbs.H100_SMS) >= lanes
    numel = gibbs.sweep_scratch_numel(chains, 690, lanes)
    assert numel == (gibbs.SWEEP_FIELDS * 690 * chains if lanes == gibbs.SWEEP_THREADS else 0)


@pytest.mark.parametrize("chains", [1, 256, 1024, 8448, 40000])
@pytest.mark.parametrize("dim", [1, 48, 49, 61, 167, 1088, 1089, 1280, 2049, 40000])
def test_torch_gibbs_sweep_layout_takes_any_width(chains, dim):
    """``sweep_layout``: B in registers on the larger of ``sweep_lanes(C)`` and
    the fewest lanes of a warp that keep SWEEP_ENT_MAX entries a lane or
    fewer; the wide layout exactly where 32 lanes do not (D > 32
    SWEEP_ENT_MAX), a block of warps a chain: the fewest warps that keep
    SWEEP_ENT_MAX entries a lane, raised while the launch stays within
    SWEEP_WARPS_PER_SM warps an SM, at most SWEEP_WIDE_WARPS (256 threads: 255
    registers each fit an SM's 65,536); past that many warps B leaves the
    registers for shared memory (while it fits a block's) or the output buffer,
    on SWEEP_MEMORY_WARPS warps.  Either way the lanes' entries cover D."""
    layout = gibbs.sweep_layout(chains, dim)
    _, code = gibbs.choose_layout(chains, dim)
    assert layout.lanes * layout.entries >= dim > layout.lanes * (layout.entries - 1)
    assert layout.wide == (-(-dim // gibbs.SWEEP_THREADS) > gibbs.SWEEP_ENT_MAX)
    if not layout.wide:
        assert code == gibbs.SWEEP_REGISTERS
        assert layout.lanes in gibbs.SWEEP_LANES
        assert layout.entries <= gibbs.SWEEP_ENT_MAX
        assert layout.lanes >= gibbs.sweep_lanes(chains)
        # no fewer lanes would do: the chain count's own, or too many entries a lane
        assert layout.lanes == gibbs.sweep_lanes(chains) or -(-dim // (layout.lanes // 2)) > gibbs.SWEEP_ENT_MAX
        return
    warps, budget = layout.warps, gibbs.SWEEP_WARPS_PER_SM * gibbs.H100_SMS
    assert layout.lanes == gibbs.SWEEP_THREADS * warps
    fewest = -(-dim // (gibbs.SWEEP_THREADS * gibbs.SWEEP_ENT_MAX))
    if fewest <= gibbs.SWEEP_WIDE_WARPS:
        assert code == gibbs.SWEEP_WIDE_REGISTERS and layout.in_registers
        assert fewest <= warps <= gibbs.SWEEP_WIDE_WARPS and layout.entries <= gibbs.SWEEP_ENT_MAX
        assert layout.lanes * 255 <= 65_536  # the register budget of an SM
        assert warps == fewest or warps * chains <= budget  # raised only within the budget,
        assert warps == gibbs.SWEEP_WIDE_WARPS or (warps + 1) * chains > budget or warps == fewest  # and as far
        assert gibbs.sweep_warps(chains, dim, sm_count=2 * gibbs.H100_SMS) >= warps
    else:  # B leaves the registers
        assert warps == gibbs.SWEEP_MEMORY_WARPS and not layout.in_registers
        shared = 4 * dim + gibbs.SWEEP_EXCHANGE_BYTES <= gibbs.H100_SHARED_OPTIN
        assert code == (gibbs.SWEEP_WIDE_SHARED if shared else gibbs.SWEEP_WIDE_GLOBAL)
    assert gibbs.sweep_shared_bytes(dim) == 4 * dim + gibbs.SWEEP_EXCHANGE_BYTES


@pytest.mark.parametrize("forced, want", [
    ({"lanes": 32}, (32, 34, False, gibbs.SWEEP_REGISTERS)),
    ({"warps": 1}, (32, 34, True, gibbs.SWEEP_WIDE_REGISTERS)),
    ({"warps": 8}, (256, 5, True, gibbs.SWEEP_WIDE_REGISTERS)),
    ({"b_memory": "shared"}, (256, 5, True, gibbs.SWEEP_WIDE_SHARED)),
    ({"b_memory": "global"}, (256, 5, True, gibbs.SWEEP_WIDE_GLOBAL)),
    ({"warps": 16}, (512, 3, True, gibbs.SWEEP_WIDE_SHARED)),
], ids=["lanes", "one-warp", "eight-warps", "shared", "global", "sixteen-warps"])
def test_torch_gibbs_sweep_forced_layouts(forced, want):
    """What ``choose_layout`` gives where a check forces a layout at (64, 1,088), where the wrapper takes
    32 lanes: B in shared memory or the output buffer keeps the wrapper's wide warps (8 at 64 chains), so
    its sums run in the order of the wide layout in registers; past SWEEP_WIDE_WARPS warps B is in memory."""
    layout, code = gibbs.choose_layout(64, 1088, **forced)
    assert (layout.lanes, layout.entries, layout.wide, code) == want
    assert gibbs.choose_layout(64, 1088) == (gibbs.SweepLayout(32, 34, False), gibbs.SWEEP_REGISTERS)


@pytest.mark.parametrize("forced, match", [
    ({"lanes": 32, "warps": 2}, "register layout"), ({"lanes": 16}, "register layout"),
    ({"warps": 0}, "1 to 16 warps"), ({"warps": 17}, "1 to 16 warps"), ({"b_memory": "l2"}, "b_memory takes"),
], ids=["lanes-and-warps", "too-many-entries", "no-warps", "past-the-warps", "nowhere"])
def test_torch_gibbs_sweep_refuses_a_layout_it_does_not_build(forced, match):
    with pytest.raises(ValueError, match=match):
        gibbs.choose_layout(64, 1088, **forced)


def test_torch_gibbs_sweep_refuses_b_in_shared_memory_past_the_card():
    """Past the card's shared memory a block, B in shared memory is refused (the wrapper's own layout takes
    the output buffer there)."""
    dim = (gibbs.H100_SHARED_OPTIN - gibbs.SWEEP_EXCHANGE_BYTES) // 4 + 1
    assert gibbs.choose_layout(4, dim)[1] == gibbs.SWEEP_WIDE_GLOBAL
    assert gibbs.choose_layout(4, dim - 1)[1] == gibbs.SWEEP_WIDE_SHARED
    with pytest.raises(ValueError, match="shared memory"):
        gibbs.choose_layout(4, dim, b_memory="shared")


def test_torch_gibbs_sweep_constants_mirror_the_cuda_source():
    """The wrapper's mirrors of G1's constants are the source's: entries a lane, warps a chain, the step
    constants' fields, and the bytes of the warps' exchange (2 steps x kMemoryWarps x (R, Q) floats and an
    8-byte mbarrier)."""
    source = (Path(gibbs.__file__).resolve().parents[1] / "ops" / "csrc" / "gibbs.cu").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))

    assert constant("kEntMax") == gibbs.SWEEP_ENT_MAX
    assert constant("kWideWarps") == gibbs.SWEEP_WIDE_WARPS
    assert constant("kMemoryWarps") == gibbs.SWEEP_MEMORY_WARPS
    assert constant("kSweepThreads") == gibbs.SWEEP_THREADS
    assert "float part[2][kMemoryWarps][2];" in source and "unsigned long long bar;" in source
    assert gibbs.SWEEP_EXCHANGE_BYTES == 2 * gibbs.SWEEP_MEMORY_WARPS * 2 * 4 + 8
    assert re.search(r"enum StepField \{(.*?)\}", source).group(1).count(",") == gibbs.SWEEP_FIELDS
    codes = re.search(r"enum SweepLayout \{(.*?)\}", source).group(1)
    assert [int(v) for v in re.findall(r"= (\d)", codes)] == [gibbs.SWEEP_REGISTERS, gibbs.SWEEP_WIDE_REGISTERS,
                                                               gibbs.SWEEP_WIDE_SHARED, gibbs.SWEEP_WIDE_GLOBAL]


@pytest.mark.parametrize("dims", [(0, 1), (1, 0)])
def test_torch_gibbs_sweep_layout_refuses_no_chains_or_width(dims):
    with pytest.raises(ValueError, match="C >= 1 and D >= 1"):
        gibbs.sweep_layout(*dims)
