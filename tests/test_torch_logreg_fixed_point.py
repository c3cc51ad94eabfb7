"""Port parity: RMHMC's two fixed points (``ops.logreg_fixed_point``) against the JAX package's loops.

The plain versions are the sampler's loops moved out of ``samplers/rmhmc.py``.
Here they run on the CPU against the same loops written with the JAX
package's model and ops (``riemannhamiltonianmontecarlo_tpu/samplers/rmhmc.py``:
the position loop ``:208-217`` with ``model.metric`` and ``ops.solve_psd``
(``method="unrolled"``), the momentum rounds ``:193-195`` and the explicit
half-step ``:220-223`` through ``momentum_force``), on inputs made with numpy
from a seed: 64 chains, N = 690, D = 15 and 3, Student-t off and on, dt of
both signs.  Tolerance: rtol 1e-5, atol 1e-6 -- float32 sums over the 690
rows in another order.

The kernels K4 / K5 (``csrc/logreg_fixed_point.cu``) run only on a card
(``chip_smoke.py`` holds them against the plain versions in float64 there).
Here: that a non-PD G spoils its own chain only, which route the sampler and
the model take on which batch, what the ``*_cuda`` wrappers hand to the
launch and what they refuse before it, the layout mirrored from the source,
and ``chip_smoke.py``'s bound and launch formulas.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import riemannhamiltonianmontecarlo_tpu as rj
from riemannhamiltonianmontecarlo_tpu import ops as jops
from riemannhamiltonianmontecarlo_tpu_torch import interop, models
from riemannhamiltonianmontecarlo_tpu_torch.ops import _build, hopper_linalg
from riemannhamiltonianmontecarlo_tpu_torch.ops import logreg_fixed_point as lfp
from riemannhamiltonianmontecarlo_tpu_torch.samplers import rmhmc
from riemannhamiltonianmontecarlo_tpu_torch.samplers import stochvol as tsv

torch.set_num_threads(1)
C, N, ROUNDS = 64, 690, 4
RTOL, ATOL = 1e-5, 1e-6
HIGHEST = jax.lax.Precision.HIGHEST


@pytest.fixture(scope="module", params=[15, 3], ids=["D15", "D3"])
def problem(request):
    """Both models on one synthetic data set and the fixed points' inputs, float32, from numpy seeded by D."""
    d = request.param
    ds = models.synthetic_logreg(seed=d, n=N, d=d)
    x, t = ds.X.astype(np.float32), ds.t.astype(np.float32)
    jm = rj.models.LogisticRegression(jnp.asarray(x), jnp.asarray(t))
    tm = interop.logreg_from_numpy(x, t, device="cpu")
    rng = np.random.default_rng(100 + d)
    w = (np.asarray(rj.utils.map_estimate(jm)) + 0.1 * rng.normal(size=(C, d))).astype(np.float32)
    g = np.asarray(jm.metric(jnp.asarray(w))).astype(np.float64)
    inv = np.linalg.inv(g)
    inv = (0.5 * (inv + np.swapaxes(inv, -1, -2))).astype(np.float32)
    p = np.einsum("cab,cb->ca", np.linalg.cholesky(g), rng.normal(size=(C, d))).astype(np.float32)
    u0 = np.einsum("cab,cb->ca", inv.astype(np.float64), p).astype(np.float32)
    arrays = {
        "w": w, "inv": inv, "p": p, "u0": u0,
        "cache": np.array(jm.dg_cache(jnp.asarray(w))),
        "base": rng.normal(size=(C, d)).astype(np.float32),
        "dt": np.where(rng.random(C) < 0.5, 0.5, -0.5).astype(np.float32),
    }
    assert (arrays["dt"] > 0).any() and (arrays["dt"] < 0).any()
    return d, jm, tm, arrays


def torch_args(arrays, *names):
    return [torch.from_numpy(arrays[name]) for name in names]


def jax_args(arrays, *names):
    return [jnp.asarray(arrays[name]) for name in names]


def jax_position(jm, w, pm, u0_eff, dt, student_t: bool, jitter: float = 0.0):
    """The JAX step's implicit position step (rmhmc.py:208-217)."""
    d, dt = w.shape[-1], dt[:, None]
    wf = w
    for _ in range(ROUNDS):
        g_new = jm.metric(wf)
        if jitter:
            g_new = g_new + jitter * jnp.eye(d, dtype=g_new.dtype)
        u_new = jops.solve_psd(g_new, pm, method="unrolled")
        if student_t:
            qn = jnp.sum(pm * u_new, axis=-1, keepdims=True)
            u_new = (1.0 + d) * u_new / (1.0 + qn)
        wf = w + 0.5 * dt * (u0_eff + u_new)
    return wf


def jax_momentum(jm, w, inv, cache, p, pm0, base, dt, student_t: bool, rounds: int):
    """The JAX step's momentum rounds (rmhmc.py:193-195; one round from pm0 = p: the half-step, :220-223),
    through its ``momentum_force`` (:166-185)."""
    d, dt = w.shape[-1], dt[:, None]
    pm = pm0
    for _ in range(rounds):
        u_vec = jnp.einsum("...ab,...b->...a", inv, pm, precision=HIGHEST)
        bil = jm.dg_bilinear(w, u_vec, u_vec, cache=cache)
        if student_t:
            quad = jnp.sum(pm * u_vec, axis=-1, keepdims=True)
            last = 0.5 * (1.0 + d) * bil / (1.0 + quad)
        else:
            last = 0.5 * bil
        pm = p + 0.5 * dt * (base + last)
    return pm


def student_t_u0(u0, p, d):
    return (1.0 + d) * u0 / (1.0 + np.sum(p * u0, axis=-1, keepdims=True))


@pytest.mark.parametrize("student_t", [False, True], ids=["gauss", "student_t"])
def test_torch_position_fixed_point_plain_matches_jax(problem, student_t):
    d, jm, tm, a = problem
    u0 = (student_t_u0(a["u0"], a["p"], d) if student_t else a["u0"]).astype(np.float32)
    got = lfp.position_fixed_point_plain(tm, *torch_args(a, "w", "p"), torch.from_numpy(u0),
                                         torch.from_numpy(a["dt"]), rounds=ROUNDS, student_t=student_t)
    want = jax_position(jm, *jax_args(a, "w", "p"), jnp.asarray(u0), jnp.asarray(a["dt"]), student_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rounds", [ROUNDS, 1], ids=["fixed_point", "half_step"])
@pytest.mark.parametrize("student_t", [False, True], ids=["gauss", "student_t"])
def test_torch_momentum_fixed_point_plain_matches_jax(problem, student_t, rounds):
    """The fixed point from pm0 = p, and the explicit half-step: one round with p = pm0 = the fixed point's pm."""
    d, jm, tm, a = problem
    if rounds == 1:
        pm = jax_momentum(jm, *jax_args(a, "w", "inv", "cache", "p", "p", "base", "dt"), student_t, ROUNDS)
        a = {**a, "p": np.array(pm)}
    got = lfp.momentum_fixed_point_plain(tm, *torch_args(a, "w", "inv", "cache", "p", "p", "base", "dt"),
                                         rounds=rounds, student_t=student_t)
    want = jax_momentum(jm, *jax_args(a, "w", "inv", "cache", "p", "p", "base", "dt"), student_t, rounds)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kernel", ["position", "momentum"])
def test_torch_fixed_point_non_pd_chain_spoils_its_row_only(problem, kernel):
    """Position: a chain whose v are all 0 (w scaled by 1e6: every logit past the sigmoid's range) under a
    jitter of -1.001 / alpha has G = -0.001 I / alpha; momentum: a chain's G^-1 NaN, as K3 leaves a non-PD G's.
    That chain's row is non-finite, every other chain finite and the same as without it."""
    d, jm, tm, a = problem
    bad = C // 2
    ok = np.arange(C) != bad
    if kernel == "position":
        jitter = float(np.float32(chip_smoke.FIXED_POINT_JITTER_NON_PD / tm.alpha))
        w = a["w"].copy()
        w[bad] *= 1e6
        run = lambda w_: lfp.position_fixed_point_plain(tm, torch.from_numpy(w_), *torch_args(a, "p", "u0", "dt"),
                                                        rounds=ROUNDS, jitter=jitter)
        got, clean = run(w), run(a["w"])
    else:
        inv = a["inv"].copy()
        inv[bad] = np.nan
        run = lambda inv_: lfp.momentum_fixed_point_plain(tm, torch.from_numpy(a["w"]), torch.from_numpy(inv_),
                                                          *torch_args(a, "cache", "p", "p", "base", "dt"),
                                                          rounds=ROUNDS)
        got, clean = run(inv), run(a["inv"])
    assert not torch.isfinite(got[bad]).all()
    assert torch.isfinite(got[ok]).all()
    np.testing.assert_allclose(got[ok].numpy(), clean[ok].numpy(), rtol=RTOL, atol=ATOL)


# -- routes ---------------------------------------------------------------------


def small_blr():
    ds = models.synthetic_logreg(seed=1, n=60, d=5)
    return interop.logreg_from_numpy(ds.X, ds.t, device="cpu")


def counting(monkeypatch, owner, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        inner = getattr(owner, name)

        def counted(*args, _name=name, _inner=inner, **kw):
            calls[_name] += 1
            return _inner(*args, **kw)

        monkeypatch.setattr(owner, name, counted)
    return calls


@pytest.mark.parametrize("linalg", [None, "unrolled"])
def test_torch_rmhmc_takes_the_models_fixed_points(monkeypatch, linalg):
    """RMHMC on a logistic regression calls the model's two methods, L position and 2 L momentum calls a step
    (the fixed point and the half-step), passing ``config.linalg``; on a CPU batch both take the plain loops,
    and the kernels' wrappers are never reached."""
    model = small_blr()
    monkeypatch.setattr(lfp, "position_fixed_point_cuda", lambda *a, **k: pytest.fail("a CPU batch reached K4"))
    monkeypatch.setattr(lfp, "momentum_fixed_point_cuda", lambda *a, **k: pytest.fail("a CPU batch reached K5"))
    seen = []
    inner = models.LogisticRegression.fixed_point_kernels
    monkeypatch.setattr(models.LogisticRegression, "fixed_point_kernels",
                        lambda self, w, linalg=None: seen.append(linalg) or inner(self, w, linalg))
    calls = counting(monkeypatch, models.LogisticRegression, ("position_fixed_point", "momentum_fixed_point"))
    cfg = rmhmc.RMHMCConfig(num_leapfrog=3, linalg=linalg)
    kernel = rmhmc.build(model, cfg)
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        state = kernel.init(torch.zeros((4, model.dim)) + 0.01)
        for _ in range(2):
            state, info = kernel.step(gen, state)
    assert calls == {"position_fixed_point": 2 * cfg.num_leapfrog, "momentum_fixed_point": 4 * cfg.num_leapfrog}
    assert set(seen) == {linalg} and torch.isfinite(state.position).all()


def test_torch_stochvol_hyper_block_runs_the_sampler_loops(monkeypatch):
    """StochVol's hyper manifold has no fixed-point methods: RMHMC runs the plain loops on it."""
    calls = counting(monkeypatch, lfp, ("position_fixed_point_plain", "momentum_fixed_point_plain"))
    model_calls = counting(monkeypatch, models.LogisticRegression, ("position_fixed_point", "momentum_fixed_point"))
    y = np.random.default_rng(0).normal(size=40) * 0.5
    kernel = tsv.build(interop.stochvol_from_numpy(y, device="cpu"), tsv.StochVolConfig(method="rmhmc"))
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        kernel.step(gen, kernel.init(torch.full((4, 3), 0.5)))
    hyper_l = tsv.StochVolConfig().hyper_num_leapfrog
    assert calls == {"position_fixed_point_plain": hyper_l, "momentum_fixed_point_plain": 2 * hyper_l}
    assert model_calls == {"position_fixed_point": 0, "momentum_fixed_point": 0}


def test_torch_fixed_point_kernels_route():
    """K4 / K5 only for a whole model's (C, D) CUDA batch under linalg None or "kernel", of a width the kernels
    serve faster than the loops: the exact widths (25 among them) and the capacities up to 16 rows, not 17-24 or
    26-48 (measured on the card: PERF.md)."""
    model = small_blr()

    class Cuda:  # what the rule reads of a batch
        is_cuda, ndim = True, 2

    assert model.fixed_point_kernels(Cuda()) and model.fixed_point_kernels(Cuda(), "kernel")
    assert [d for d in range(1, lfp.MAX_DIM + 2) if lfp.kernel_width(d)] == [*range(1, 17), 25]
    for d, kernels in ((15, True), (16, True), (20, False), (25, True), (32, False), (48, False)):
        ds = models.synthetic_logreg(seed=1, n=30, d=d)
        assert interop.logreg_from_numpy(ds.X, ds.t, device="cpu").fixed_point_kernels(Cuda()) is kernels
    assert not model.fixed_point_kernels(Cuda(), "unrolled") and not model.fixed_point_kernels(Cuda(), "library")
    assert not model.fixed_point_kernels(torch.zeros((4, 5)))  # a CPU batch
    model.group = object()  # a data-sharded model: its metric is all-reduced between the build and the factor
    assert not model.fixed_point_kernels(Cuda())


def test_torch_fixed_point_dispatch_takes_the_plain_version_on_cpu(problem, monkeypatch):
    d, jm, tm, a = problem
    monkeypatch.setattr(lfp, "position_fixed_point_cuda", lambda *a, **k: pytest.fail("a CPU tensor reached K4"))
    monkeypatch.setattr(lfp, "momentum_fixed_point_cuda", lambda *a, **k: pytest.fail("a CPU tensor reached K5"))
    got = lfp.position_fixed_point(tm, *torch_args(a, "w", "p", "u0", "dt"), rounds=2)
    assert torch.equal(got, lfp.position_fixed_point_plain(tm, *torch_args(a, "w", "p", "u0", "dt"), rounds=2))
    args = torch_args(a, "w", "inv", "cache", "p", "p", "base", "dt")
    assert torch.equal(lfp.momentum_fixed_point(tm, *args, rounds=2), lfp.momentum_fixed_point_plain(tm, *args, rounds=2))


# -- the wrappers without a card --------------------------------------------------


@pytest.fixture
def recorded_launches(monkeypatch):
    """The wrappers with the card patched away: CPU tensors pass the device check and ``_launch`` records."""
    seen = []
    monkeypatch.setattr(lfp, "_KERNEL_DEVICE", "cpu")
    monkeypatch.setattr(lfp, "_launch", lambda name, symbol, device, *args: seen.append((name, symbol, args)))
    return seen


def wrapper_inputs(c=6, n=11, d=5):
    g = torch.Generator().manual_seed(0)
    r = lambda *shape: torch.randn(shape, generator=g)  # noqa: E731
    return {"x": r(n, d), "w": r(c, d), "pm": r(c, d), "u0": r(c, d), "dt": r(c), "inv": r(c, d, d), "cache": r(c, n),
            "p": r(c, d), "pm0": r(c, d), "base": r(c, d)}


def call(kind: str, t: dict, **kw):
    if kind == "position":
        return lfp.position_fixed_point_cuda(t["x"], t["w"], t["pm"], t["u0"], t["dt"], alpha=100.0, rounds=4, **kw)
    return lfp.momentum_fixed_point_cuda(t["x"], t["inv"], t["cache"], t["p"], t["pm0"], t["base"], t["dt"], rounds=4,
                                         **kw)


@pytest.mark.parametrize("kind", ["position", "momentum"])
def test_torch_fixed_point_cuda_hands_over_its_operands(recorded_launches, kind):
    """One launch with the operands' own storage (no copy), the output from ``torch.empty``, (C, N, D), the
    scalars rounded to float32 (1 / alpha as the float32 reciprocal) and the Student-t flag as an int."""
    t = wrapper_inputs()
    out = call(kind, t, student_t=True, **({"jitter": 1e-3} if kind == "position" else {}))
    (name, symbol, args), = recorded_launches
    if kind == "position":
        assert (name, symbol) == ("position_fixed_point", "rhmc_position_fixed_point")
        ptrs = [t[k].data_ptr() for k in ("x", "w", "pm", "u0", "dt")]
        assert list(args[:5]) == ptrs and args[5] == out.data_ptr()
        assert args[6:] == (6, 11, 5, float(np.float32(1.0) / np.float32(100.0)), float(np.float32(1e-3)), 4, 1)
    else:
        assert (name, symbol) == ("momentum_fixed_point", "rhmc_momentum_fixed_point")
        ptrs = [t[k].data_ptr() for k in ("x", "inv", "cache", "p", "pm0", "base", "dt")]
        assert list(args[:7]) == ptrs and args[7] == out.data_ptr()
        assert args[8:] == (6, 11, 5, 4, 1)
    assert out.shape == (6, 5) and out.is_contiguous() and out.dtype == torch.float32


@pytest.mark.parametrize("bad", ["cpu", "wide", "dtype", "strided", "shape", "mixed-devices", "no-rows", "rounds"])
@pytest.mark.parametrize("kind", ["position", "momentum"])
def test_torch_fixed_point_cuda_refuses(monkeypatch, kind, bad):
    t = wrapper_inputs()
    if bad == "cpu":  # the real device check
        with pytest.raises(ValueError, match="CUDA tensors"):
            call(kind, t)
        return
    seen = []
    monkeypatch.setattr(lfp, "_KERNEL_DEVICE", "cpu")
    monkeypatch.setattr(lfp, "_launch", lambda *args: seen.append(args))
    target = "w" if kind == "position" else "p"
    if bad == "wide":  # a width the kernels do not serve (the model takes the loops there)
        t = wrapper_inputs(d=20)
        match = "1 <= D <= 16 or D 25"
    elif bad == "dtype":
        t[target] = t[target].double()
        match = "float32"
    elif bad == "strided":
        t[target] = torch.randn(5, 6).T
        match = "not contiguous"
    elif bad == "shape":
        t[target] = t[target][:, :4].contiguous()
        match = f"{target} must be a \\(6, 5\\)"
    elif bad == "mixed-devices":
        t[target] = t[target].to("meta")
        match = f"{target} must be .* on cpu"
    elif bad == "no-rows":
        t["x"], t["cache"] = t["x"][:0], t["cache"][:, :0]
        match = "N >= 1"
    else:
        match = "rounds must be >= 0"
        with pytest.raises(ValueError, match=match):
            (lfp.position_fixed_point_cuda(t["x"], t["w"], t["pm"], t["u0"], t["dt"], alpha=100.0, rounds=-1)
             if kind == "position" else
             lfp.momentum_fixed_point_cuda(t["x"], t["inv"], t["cache"], t["p"], t["pm0"], t["base"], t["dt"],
                                           rounds=-1))
        assert seen == []
        return
    with pytest.raises(ValueError, match=match):
        call(kind, t)
    assert seen == []


def test_torch_fixed_point_cuda_launches_nothing_on_an_empty_batch(recorded_launches):
    t = wrapper_inputs(c=0)
    assert call("position", t).shape == (0, 5) and call("momentum", t).shape == (0, 5) and recorded_launches == []


# -- the source's layout, names and chip_smoke's formulas ---------------------------


def cuda_source_constant(name: str) -> int:
    src = (_build.CSRC_DIR / "logreg_fixed_point.cu").read_text()
    (expr,) = re.findall(rf"constexpr int {name} = ([^;]+);", src)
    return int(eval(expr, {}))  # noqa: S307 -- a product of integer literals in the checked-in source


def test_torch_fixed_point_layout_mirrors_the_source():
    """The layout of ``csrc/logreg_fixed_point.cu::k4_layout`` / ``k5_layout`` (``chip_smoke.py`` holds the mirror
    against the built library): K4 512 threads and 32 chains a block (16 at D 25), X whole in one copy where it
    fits beside the pair table, weights, sum, iterates and factor tile, else streamed through two stages of a
    multiple of the chunk's rows; K5 8 warps, X and c in copies of 256 rows, all resident where at most 8 fit,
    else a ring of three.  Both serve D <= 16 and D 25 only."""
    assert lfp.SHARED_OPT_IN == cuda_source_constant("kSmemMax") == 227 * 1024
    assert lfp.STREAM_BYTES == cuda_source_constant("kStreamBytes")
    assert lfp.K4_V_FLOATS == cuda_source_constant("kVFloats")
    assert lfp.K4_XX_FLOATS == cuda_source_constant("kXXFloats")
    assert lfp.K4_THREADS == cuda_source_constant("kK4Threads") == 512
    assert lfp.K4_MAX_SETS == cuda_source_constant("kK4MaxSets")
    src = (_build.CSRC_DIR / "logreg_fixed_point.cu").read_text()
    assert "bool fp_width(int d) { return d >= 1 && (d <= 16 || d == 25); }" in src
    assert src.count("return with_fp_width(d, [&](auto width) {") == 3 and "return with_width(d" not in src
    assert lfp.K5_THREADS == cuda_source_constant("kK5Threads") == 256
    assert lfp.K5_COPY == cuda_source_constant("kK5Copy")
    assert lfp.K5_PASS == cuda_source_constant("kK5Pass")
    assert lfp.K5_MAX_COPIES == cuda_source_constant("kK5MaxCopies")
    assert lfp.K5_RING_STAGES == cuda_source_constant("kK5RingStages")
    for d in range(1, lfp.MAX_DIM + 1):
        lanes = hopper_linalg.launch_geometry(d).lanes_per_chain
        if not lfp.kernel_width(d):
            for kernel in (lfp.POSITION, lfp.MOMENTUM):
                with pytest.raises(ValueError, match="D <= 16 or D 25"):
                    lfp.launch_geometry(kernel, 690, d)
            continue
        for n in (1, 33, 690, 1000, 5000, 20000):
            g = lfp.launch_geometry(lfp.POSITION, n, d)
            assert g.threads == 512 and g.chains == min(32, 512 // lanes)
            assert g.chunk_rows == lfp.k4_tiles(d).chunk and g.shared_bytes <= lfp.SHARED_OPT_IN
            assert (g.whole, g.stages, g.tile_rows) == (1, 1, n) if g.whole else (
                g.stages == 2 and g.tile_rows % g.chunk_rows == 0 and g.chunk_rows <= g.tile_rows < n
                and g.tile_rows * d * 4 <= lfp.STREAM_BYTES)
            g = lfp.launch_geometry(lfp.MOMENTUM, n, d)
            assert g.threads == 256 and g.chains == 8 * lfp.k5_tiles(d).chains_per_warp
            assert (g.chunk_rows, g.tile_rows) == (64, 256) and g.shared_bytes <= lfp.SHARED_OPT_IN
            assert g.stages == -(-n // 256) <= 8 if g.whole else g.stages == 3
    assert lfp.launch_geometry(lfp.POSITION, 690, 15) == lfp.FixedPointGeometry(512, 32, 64, 690, 1, 1, 165984)
    assert lfp.launch_geometry(lfp.MOMENTUM, 690, 15) == lfp.FixedPointGeometry(256, 32, 64, 256, 3, 1, 151712)
    assert lfp.launch_geometry(lfp.POSITION, 1000, 25) == lfp.FixedPointGeometry(512, 16, 24, 1000, 1, 1, 229136)
    assert lfp.launch_geometry(lfp.MOMENTUM, 1000, 25) == lfp.FixedPointGeometry(256, 16, 64, 256, 4, 1, 174272)
    assert lfp.launch_geometry(lfp.POSITION, 20000, 15) == lfp.FixedPointGeometry(512, 32, 64, 896, 2, 0, 232144)
    assert lfp.launch_geometry(lfp.MOMENTUM, 20000, 15).whole == 0  # chip_smoke's streamed shape
    assert any(not lfp.launch_geometry(lfp.POSITION, n, d).whole for _, n, d in chip_smoke.FIXED_POINT_SHAPES)


@pytest.mark.parametrize("d", range(1, lfp.MAX_DIM + 1))
def test_torch_k4_blocks_cover_the_metric(d):
    """K4's register tiles: in each set of threads, the threads' (chains x pair-table columns) tiles cover every
    chain of the block and every pair (i, j), i <= j, of the width the kernel is unrolled for exactly once, the
    padding columns beyond; the sets split a chunk's rows; the block's chains are the factor's groups; the
    threads' logits cover each (row of a chunk, chain) once.  A width the kernels do not serve has
    no tiles."""
    if not lfp.kernel_width(d):
        with pytest.raises(ValueError, match="D <= 16 and D 25"):
            lfp.k4_tiles(d)
        return
    k, n = lfp.k4_tiles(d), lfp._unrolled_rows(d)
    assert k.chains * hopper_linalg.launch_geometry(d).lanes_per_chain == k.factor_threads <= k.threads
    assert k.factor_threads % 32 == 0 and k.chains == (32 if n <= 16 else 16)  # whole warps factor; 128 blocks at C 4,096
    assert k.padded_pairs % k.pairs_per_thread == 0 and k.padded_pairs - k.pairs < k.pairs_per_thread
    assert k.sets >= 1 and k.sets * k.set_threads <= k.threads and k.chunk == k.sets * k.rows_per_set
    assert k.chunk * k.chains <= lfp.K4_V_FLOATS or k.rows_per_set == 1
    pairs = [lfp.pair_of(p, n) for p in range(k.padded_pairs)]
    assert sorted(p for p in pairs if p) == [(i, j) for i in range(n) for j in range(i, n)]
    assert all(p is None for p in pairs[k.pairs:]) and all(
        lfp.pair_of(p, n)[0] * n - lfp.pair_of(p, n)[0] * (lfp.pair_of(p, n)[0] - 1) // 2
        + lfp.pair_of(p, n)[1] - lfp.pair_of(p, n)[0] == p for p in range(k.pairs))
    cover = {}
    for t in range(k.threads):
        tile = lfp.k4_thread_tile(d, t)
        if tile is None:
            continue
        s, chains, cols = tile
        for c in chains:
            for p in cols:
                cover[s, c, p] = cover.get((s, c, p), 0) + 1
    assert set(cover.values()) == {1}
    assert set(cover) == {(s, c, p) for s in range(k.sets) for c in range(k.chains) for p in range(k.padded_pairs)}
    logits = {}
    for t in range(k.threads):
        c, rows = lfp.k4_logit_tile(d, t)
        for r in rows:
            logits[r, c] = logits.get((r, c), 0) + 1
    assert set(logits.values()) == {1} and set(logits) == {(r, c) for r in range(k.chunk) for c in range(k.chains)}
    # the sets' tiles fit over the pair table and weights, or the scratch grows to hold them
    assert k.scratch >= 2 * k.chunk * (k.padded_pairs + k.chains) and k.scratch >= k.sets * k.chains * k.padded_pairs
    assert k.one_pass_sum == (k.sets > 4) == (n <= 8)  # one pass at D <= 8 (measured faster there), else set by set
    assert lfp.k4_tiles(15) == lfp.K4Tiles(512, 32, 512, 4, 8, 120, 120, 120, 4, 16, 64, 16, 19456, False)
    assert lfp.k4_tiles(7) == lfp.K4Tiles(512, 32, 256, 4, 8, 28, 32, 32, 16, 4, 64, 16, 16384, True)
    assert lfp.k4_tiles(25) == lfp.K4Tiles(512, 16, 512, 4, 8, 325, 328, 164, 3, 8, 24, 32, 16512, False)


@pytest.mark.parametrize("d", range(1, lfp.MAX_DIM + 1))
def test_torch_k5_tiles_cover_the_force(d):
    """K5's tiles: the warps' chains cover the block's chains exactly once, and after the halving exchange
    every (chain, column) entry of a warp's b is held by lanes_per_entry lanes, exactly one of them writing it,
    the columns the width's (padding past it).  A width the kernels do not serve has no tiles."""
    if not lfp.kernel_width(d):
        with pytest.raises(ValueError, match="D <= 16 and D 25"):
            lfp.k5_tiles(d)
        return
    k, n = lfp.k5_tiles(d), lfp._unrolled_rows(d)
    assert k.chains == k.threads // 32 * k.chains_per_warp and k.padded_width >= n
    assert k.padded_width & (k.padded_width - 1) == 0 and k.padded_width < 2 * max(n, 2) + 4
    held, written = {}, {}
    for lane in range(32):
        for entry in lfp.k5_owned(d, lane):
            held[entry] = held.get(entry, 0) + 1
            if lane % k.lanes_per_entry == 0:
                written[entry] = written.get(entry, 0) + 1
    entries = {(c, col) for c in range(k.chains_per_warp) for col in range(k.padded_width)}
    assert set(held) == set(written) == entries
    assert set(held.values()) == {k.lanes_per_entry} and set(written.values()) == {1}
    assert lfp.k5_tiles(15) == lfp.K5Tiles(256, 32, 4, 16, 2, 1)
    assert lfp.k5_tiles(25) == lfp.K5Tiles(256, 16, 2, 32, 2, 1)


def test_torch_fixed_point_kernel_names_are_apart():
    """chip_smoke matches device events to kernels by a part of their names: K4's and K5's are the source's two
    kernels and hold no other kernel's name, nor does any other hold theirs."""
    src = (_build.CSRC_DIR / "logreg_fixed_point.cu").read_text()
    kernels = re.findall(r"__global__ void __launch_bounds__\(.*?\)\n\s+(\w+)\(", src)
    assert kernels == list(chip_smoke.FIXED_POINT_KERNEL_NAMES.values())
    others = [*chip_smoke.KERNEL_NAMES.values(), *chip_smoke.GIBBS_KERNEL_NAMES.values(), chip_smoke.FHN_KERNEL_NAME,
              chip_smoke.BIDIAG_KERNEL_NAME, chip_smoke.PCR_KERNEL_NAME]
    for part in kernels:
        assert not any(other in part or part in other for other in others)
    assert set(chip_smoke.FIXED_POINT_COUNTED) <= set(chip_smoke.SOMETIMES_COUNTED)


@pytest.mark.parametrize("name,rounds,expected_us,bound_by", [
    ("position_fixed_point", 4, 4096 * 4 * (2 * 690 * 15 + 690 * 15 * 16 + 15**3 / 3 + 2 * 225) / 67e6, "operations"),
    ("momentum_fixed_point", 4, 4096 * 4 * (2 * 225 + 4 * 690 * 15 + 3 * 690) / 67e6, "operations"),
    ("momentum_fixed_point", 1, 4 * (690 * 15 + 4096 * 225 + 4096 * 690 + 4 * 4096 * 15 + 4096) / 3.35e6, "bytes"),
])
def test_torch_chip_smoke_fixed_point_bound_us(name, rounds, expected_us, bound_by):
    us, by = chip_smoke.fixed_point_bound_us(name, 4096, 690, 15, rounds)
    assert us == pytest.approx(expected_us, rel=1e-12) and by == bound_by


def test_torch_chip_smoke_blr_launch_formulas():
    """A BLR RMHMC run of S steps: K3 1 + L S; on a whole model K4 L S and K5 2 L S, K2 0; on the loops K2 L K S."""
    ll, k = chip_smoke.L, chip_smoke.K
    assert chip_smoke.blr_expected_launches(10) == {"cholesky": 0, "chol_solve_logdet": 0, "chol_inv_logdet": 1 + ll * 10,
                                                   "position_fixed_point": ll * 10, "momentum_fixed_point": 2 * ll * 10}
    assert chip_smoke.blr_expected_launches(10, loops=True) == {"cholesky": 0, "chol_solve_logdet": ll * k * 10,
                                                                "chol_inv_logdet": 1 + ll * 10}
