"""Port: the Gibbs step as a fixed sequence of launches, on the CPU.

On a card a Gibbs step is K1 twice, the sweep kernel G1 once and the GIG
round kernel G2 ``max_rejection_rounds`` times, with no read of the device,
so the runner replays it as a CUDA graph.  Here the kernels' plain versions
run, and these tests hold what makes that so:

* ``sample_gig_half`` runs exactly ``max_rejection_rounds`` rounds of three
  draws (the generator's state afterwards is that of one that drew them) and
  returns, bit for bit, the ``lam`` of the early-exit loop it replaced
  (``parent_sample_gig_half`` below, a copy kept as the reference) from the
  same generator state, at r^2 in {1e-4, 1, 25} and on a mixed batch;
* ``gig_round_plain`` is one round of that loop, in place: elements already
  accepted keep their lambda;
* ``gibbs.sweep`` on the CPU is ``gibbs_sweep_plain`` (held against the
  JAX package's sweep in ``tests/test_torch_gibbs.py``);
* one Gibbs step (and its monitored kernel's) reads nothing on the host:
  ``Tensor.__bool__``, ``.item`` and ``.tolist`` patched to raise (the
  parent's loop does raise under the patch);
* the kernels' wrappers refuse a CPU tensor, and G1's a D outside 1..48.

The graph itself (``StepGraph.body`` against the eager loop) is held in
``tests/test_torch_graphs.py``; the kernels against these plain versions on
the card in ``chip_smoke.py`` phase 3.
"""

import math

import numpy as np
import pytest
import torch

import riemannhamiltonianmontecarlo_tpu_torch as rt
from riemannhamiltonianmontecarlo_tpu_torch.ops import gig, truncnorm
from riemannhamiltonianmontecarlo_tpu_torch.samplers import gibbs

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


def parent_sample_gig_half(generator, r2, max_rejection_rounds=64, max_series_bodies=32):
    r = torch.sqrt(torch.clamp(r2, min=1e-16))
    kw = dict(generator=generator, dtype=r.dtype, device=r.device)
    lam = torch.ones_like(r)
    ok = torch.zeros(r.shape, dtype=torch.bool)
    tries = 0
    while tries < max_rejection_rounds:
        for _ in range(min(4, max_rejection_rounds - tries)):
            y0 = torch.randn(r.shape, **kw) ** 2
            root = y0 + torch.sqrt(y0 * (y0 + 4.0 * r))
            y = 4.0 * r * y0 / torch.clamp(root * root, min=1e-30)
            u_side = torch.rand(r.shape, **kw)
            lam_cand = torch.clamp(torch.where(u_side <= 1.0 / (1.0 + y), r / y, r * y), min=1e-12)
            u = torch.rand(r.shape, **kw)
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


@pytest.mark.parametrize("case", R2_CASES)
def test_torch_gig_fixed_rounds_return_the_early_exit_loops_lambda(case):
    r2 = r2_batch(case)
    fixed = gig.sample_gig_half(torch.Generator().manual_seed(7), r2)
    early = parent_sample_gig_half(torch.Generator().manual_seed(7), r2)
    assert torch.isfinite(fixed).all() and (fixed > 0).all()
    assert torch.equal(fixed, early)


def test_torch_gig_fixed_rounds_draw_exactly_the_cap():
    """64 rounds of randn, rand, rand at r2's shape, whatever was decided
    (every element is accepted within the first rounds here)."""
    r2 = r2_batch("mixed")
    gen = torch.Generator().manual_seed(3)
    gig.sample_gig_half(gen, r2, max_rejection_rounds=64)
    ref = torch.Generator().manual_seed(3)
    for _ in range(64):
        torch.randn(r2.shape, generator=ref), torch.rand(r2.shape, generator=ref), torch.rand(r2.shape, generator=ref)
    assert torch.equal(gen.get_state(), ref.get_state())
    early = torch.Generator().manual_seed(3)
    parent_sample_gig_half(early, r2)
    assert not torch.equal(early.get_state(), ref.get_state())  # the early exit drew fewer


def test_torch_gig_round_plain_updates_in_place_and_keeps_the_accepted():
    gen = torch.Generator().manual_seed(5)
    r = torch.sqrt(r2_batch("mixed"))
    draws = [torch.randn(r.shape, generator=gen), torch.rand(r.shape, generator=gen), torch.rand(r.shape, generator=gen)]
    lam, ok = torch.ones_like(r), torch.zeros(r.shape, dtype=torch.bool)
    lam_ptr, ok_ptr = lam.data_ptr(), ok.data_ptr()
    gig.gig_round(r, *draws, lam, ok)
    assert lam.data_ptr() == lam_ptr and ok.data_ptr() == ok_ptr
    assert 0 < int(ok.sum()) < ok.numel()  # some accepted, some not, in one round
    assert torch.equal(lam[~ok], torch.ones_like(lam[~ok]))
    kept_lam, kept_ok = lam.clone(), ok.clone()
    again = [torch.randn(r.shape, generator=gen), torch.rand(r.shape, generator=gen), torch.rand(r.shape, generator=gen)]
    gig.gig_round_plain(r, *again, lam, ok)
    assert torch.equal(lam[kept_ok], kept_lam[kept_ok]) and bool(ok[kept_ok].all())


@pytest.mark.parametrize("wrapper", ["gig_round_cuda", "gibbs_sweep_cuda"])
def test_torch_gibbs_kernel_wrappers_refuse_cpu_tensors(wrapper):
    r = torch.ones((4, 6))
    with pytest.raises(ValueError, match="CUDA"):
        if wrapper == "gig_round_cuda":
            gig.gig_round_cuda(r, r, r, r, r.clone(), torch.zeros(r.shape, dtype=torch.bool))
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
            parent_sample_gig_half(torch.Generator().manual_seed(0), torch.ones(4))
    out_state = out.inner if monitored else out
    assert out_state.z.shape == state.z.shape and out_state.lam.shape == state.lam.shape
    assert np.isfinite(out_state.position.numpy()).all() and np.isfinite(out_state.lam.numpy()).all()


def test_torch_gibbs_capturable_where_its_model_is(gibbs_setup):
    model, kernel, _ = gibbs_setup
    assert kernel.capturable and rt.parallel.monitor(kernel, every=10).capturable
    mesh = rt.parallel.Mesh(("data",), {"data": 1}, {"data": 0}, {})
    assert not gibbs.build(model.with_sharding(mesh, "data")).capturable


@pytest.mark.parametrize("dim", [0, 49])
def test_torch_gibbs_sweep_kernel_takes_widths_1_to_48(dim):
    """G1 is instantiated once for each D in 1..48 (csrc/gibbs.cu::with_sweep_width),
    as K1 is capped: its wrapper refuses any other D, with K1's message, before
    it looks at the device; at D = 48 it goes on to refuse a CPU tensor."""
    c, n = 4, 6
    noise = truncnorm.draw_noise(torch.Generator().manual_seed(0), (n, c))
    r = torch.ones((c, n))

    def call(d):
        gibbs.gibbs_sweep_cuda(torch.ones((n, d)), torch.ones(n), r, r, r, torch.ones((c, d, n)), torch.ones((c, d)),
                               noise)

    with pytest.raises(ValueError, match=f"the CUDA kernel takes 1 <= D <= 48, got D = {dim}"):
        call(dim)
    with pytest.raises(ValueError, match="CUDA device"):
        call(48)
