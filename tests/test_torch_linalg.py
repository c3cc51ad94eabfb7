"""Port parity: the Hopper kernels' plain twins and the ops.linalg dispatch.

K3 (``chol_inv_logdet``, RMHMC's geometry in one launch) has no Pallas
counterpart: its twin is held against the JAX package's three calls.

The CUDA kernels run only on a card (``chip_smoke.py`` holds them against
these twins there).  Here the twins are held against the Pallas kernels in
interpret mode and against float64 numpy, and the CPU side of the
dispatch is checked: a CPU tensor takes the twin, never the kernel, and the
kernels' own wrappers refuse it.  What Python still decides around the
kernels is tested too: which operands the wrappers hand to the launch (the
caller's own when contiguous, one copy otherwise), the launch geometry
mirrored from the CUDA source for every width, and ``chip_smoke.py``'s bound.
"""

import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from riemannhamiltonianmontecarlo_tpu import ops as jops
from riemannhamiltonianmontecarlo_tpu.ops import pallas_linalg as plin
from riemannhamiltonianmontecarlo_tpu_torch import ops
from riemannhamiltonianmontecarlo_tpu_torch.ops import _build
from riemannhamiltonianmontecarlo_tpu_torch.ops import hopper_linalg as hl

torch.set_num_threads(1)


def spd(c, d, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(c, d, d))
    g = (a @ np.swapaxes(a, -1, -2) + d * np.eye(d)).astype(np.float32)
    b = rng.normal(size=(c, d)).astype(np.float32)
    return g, b


# Against the Pallas kernels in interpret mode: the same unrolled algorithm,
# float32 on both sides; tolerance 1e-5 relative (only rounding order differs).
@pytest.mark.parametrize("c,d", [(5, 7), (40, 6)])
def test_torch_twins_match_pallas_interpret(c, d):
    g, b = spd(c, d, seed=c + d)
    l_ref = np.asarray(plin.cholesky(jnp.asarray(g), interpret=True))
    np.testing.assert_allclose(hl.cholesky_plain(torch.from_numpy(g)).numpy(), l_ref, rtol=1e-5, atol=1e-5)
    x_ref, ld_ref = plin.chol_solve_logdet(jnp.asarray(g), jnp.asarray(b), interpret=True)
    x, ld = hl.chol_solve_logdet_plain(torch.from_numpy(g), torch.from_numpy(b))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), rtol=1e-5, atol=1e-5)


# Against float64 numpy, with the tolerances of tests/test_pallas_linalg.py.
@pytest.mark.parametrize("c,d", [(5, 7), (200, 15), (130, 25)])
def test_torch_twins_match_numpy(c, d):
    g, b = spd(c, d, seed=c + d)
    g64 = g.astype(np.float64)
    l = hl.cholesky(torch.from_numpy(g)).numpy()  # CPU tensor: the wrapper takes the twin
    np.testing.assert_allclose(l, np.linalg.cholesky(g64), rtol=2e-4, atol=2e-4)
    assert (np.triu(l, 1) == 0.0).all()  # exact zeros, not merely small
    x, ld = hl.chol_solve_logdet(torch.from_numpy(g), torch.from_numpy(b))
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(g64, b[..., None])[..., 0], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(ld.numpy(), np.linalg.slogdet(g64)[1], rtol=2e-4, atol=2e-3)


# K3's twin against the JAX package's geometry (samplers/rmhmc.py:111-118): its
# unrolled cholesky, inv_psd_from_chol and 0.5 logdet_from_chol, float32 on
# both sides; rtol / atol 1e-5 (the same operations, sums in another order).
@pytest.mark.parametrize("c,d", [(5, 7), (200, 15), (130, 25), (4, 2), (16, 3)])
def test_torch_chol_inv_logdet_twin_matches_jax(c, d):
    g, _ = spd(c, d, seed=c + d)
    lj = jops.cholesky(jnp.asarray(g), method="unrolled")
    refs = (lj, jops.inv_psd_from_chol(lj), 0.5 * jops.logdet_from_chol(lj))
    outs = hl.chol_inv_logdet_plain(torch.from_numpy(g))
    assert [tuple(o.shape) for o in outs] == [(c, d, d), (c, d, d), (c,)]
    for out, ref in zip(outs, refs):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert torch.equal(hl.chol_inv_logdet(torch.from_numpy(g))[1], outs[1])  # a CPU tensor takes the twin


# ops.chol_inv_logdet is, for every method, the three calls it stands for (on
# the CPU the kernel route is the twin, itself those calls): equal bit for bit.
@pytest.mark.parametrize("method", [None, "unrolled", "kernel", "library"])
def test_torch_chol_inv_logdet_is_the_three_calls(method):
    g, _ = spd(24, 6, seed=9)
    gt = torch.from_numpy(g)
    l = ops.cholesky(gt, method=method)
    expected = (l, ops.inv_psd_from_chol(l), 0.5 * ops.logdet_from_chol(l))
    for out, ref in zip(ops.chol_inv_logdet(gt, method=method), expected):
        assert torch.equal(out, ref)


@pytest.mark.parametrize("method", ["kernel", "unrolled", "library"])
def test_torch_non_pd_chain_is_nan_alone(method):
    g, b = spd(12, 7, seed=4)
    g[5] = -np.eye(7, dtype=np.float32)
    gt, bt = torch.from_numpy(g), torch.from_numpy(b)
    ok = np.arange(12) != 5
    l = ops.cholesky(gt, method=method).numpy()
    assert np.isfinite(l[ok]).all() and not np.isfinite(l[5]).all()
    assert (np.triu(l, 1) == 0.0).all()
    x = ops.solve_psd(gt, bt, method=method).numpy()
    assert np.isfinite(x[ok]).all() and not np.isfinite(x[5]).all()
    for out in ops.chol_inv_logdet(gt, method=method):  # L, G^-1, 1/2 log|G|
        out = out.numpy()
        assert np.isfinite(out[ok]).all() and not np.isfinite(out[5]).all()
    if method == "kernel":
        x, ld = hl.chol_solve_logdet(gt, bt)
        assert np.isfinite(ld.numpy()[ok]).all() and not np.isfinite(ld.numpy()[5])


# The dispatch against the JAX package's unrolled ops: float32 both sides,
# rtol 2e-4 / atol 2e-4 (test_pallas_linalg's cholesky tolerance).
@pytest.mark.parametrize("method", [None, "unrolled", "kernel", "library"])
def test_torch_linalg_ops_match_jax(method):
    g, b = spd(40, 6, seed=3)
    gj, bj, gt, bt = jnp.asarray(g), jnp.asarray(b), torch.from_numpy(g), torch.from_numpy(b)

    def close(port, ref):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)

    lj = jops.cholesky(gj, method="unrolled")
    lt = ops.cholesky(gt, method=method)
    close(lt, lj)
    close(ops.solve_lower_triangular(lt, bt, method=method), jops.solve_lower_triangular(lj, bj))
    close(ops.solve_upper_from_lower(lt, bt, method=method), jops.solve_upper_from_lower(lj, bj))
    close(ops.cho_solve(lt, bt, method=method), jops.cho_solve(lj, bj))
    close(ops.solve_psd(gt, bt, method=method), jops.solve_psd(gj, bj, method="unrolled"))
    close(ops.inv_psd_from_chol(lt, method=method), jops.inv_psd_from_chol(lj))
    close(ops.logdet_from_chol(lt), jops.logdet_from_chol(lj))
    # matrix right-hand side of the triangular solves, (C, D, K)
    bm = np.random.default_rng(5).normal(size=(40, 6, 3)).astype(np.float32)
    close(ops.solve_lower_triangular(lt, torch.from_numpy(bm), method=method),
          jops.solve_lower_triangular(lj, jnp.asarray(bm)))


def test_torch_mvn_sample_takes_callers_eps():
    """mvn_sample(L, eps) = L @ eps: the JAX draw replayed through the port."""
    g, _ = spd(30, 7, seed=6)
    key = jax.random.key(0)
    lj = jops.cholesky(jnp.asarray(g), method="unrolled")
    eps = np.asarray(jax.random.normal(key, (30, 7), jnp.float32))
    ref = np.asarray(jops.mvn_sample(key, lj))
    port = ops.mvn_sample(ops.cholesky(torch.from_numpy(g)), torch.tensor(eps))
    np.testing.assert_allclose(port.numpy(), ref, rtol=2e-4, atol=2e-4)


def test_torch_cpu_tensors_never_launch():
    g, b = spd(16, 7, seed=7)
    gt, bt = torch.from_numpy(g), torch.from_numpy(b)
    hl.reset_launch_counts()
    ops.cholesky(gt)
    ops.cholesky(gt, method="kernel")
    ops.solve_psd(gt, bt, method="kernel")
    hl.cholesky(gt)
    hl.chol_solve_logdet(gt, bt)
    ops.chol_inv_logdet(gt)
    ops.chol_inv_logdet(gt, method="kernel")
    hl.chol_inv_logdet(gt)
    assert hl.launch_counts() == {"cholesky": 0, "chol_solve_logdet": 0, "chol_inv_logdet": 0}


def test_torch_cuda_wrappers_refuse_cpu_tensors():
    g, b = spd(4, 5, seed=8)
    gt, bt = torch.from_numpy(g), torch.from_numpy(b)
    with pytest.raises(ValueError, match="CUDA tensor"):
        hl.cholesky_cuda(gt)
    with pytest.raises(ValueError, match="CUDA tensor"):
        hl.chol_solve_logdet_cuda(gt, bt)
    with pytest.raises(ValueError, match="CUDA tensor"):
        hl.chol_inv_logdet_cuda(gt)
    with pytest.raises(ValueError, match="method"):
        ops.cholesky(gt, method="pallas")
    with pytest.raises(ValueError, match="method"):
        ops.chol_inv_logdet(gt, method="pallas")
    assert hl.launch_counts() == {"cholesky": 0, "chol_solve_logdet": 0, "chol_inv_logdet": 0}


def test_torch_build_without_nvcc_raises(monkeypatch):
    """No toolkit means an error, never a silent fallback to the twins."""
    import torch.utils.cpp_extension as cpp_extension

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
    assert _build.library_dir().parent == _build.BUILD_ROOT
    assert _build.library_dir() == _build.library_dir()  # keyed by content, stable


def test_torch_build_key_covers_shared_headers(monkeypatch, tmp_path):
    """An edited header that the sources include (``csrc/*.cuh``) makes a new build, as an edited source does."""
    for name in ("hopper_linalg.cu", "tridiag.cu"):  # K3's factor and T1 share the IEEE fast paths
        assert '#include "fast_math.cuh"' in (_build.CSRC_DIR / name).read_text()
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = _build.library_dir()
    (tmp_path / "shared.cuh").write_text("// two\n")
    assert _build.library_dir() != before


def test_torch_build_failure_leaves_no_objects(monkeypatch, tmp_path):
    """A source that does not compile raises with nvcc's report, and no
    object file or half-built library is left beside the report."""
    class Nvcc:  # stands in for one ``nvcc -c``: writes its object, fails on fhn_sens.cu
        def __init__(self, cmd, **kwargs):
            out = cmd[cmd.index("-o") + 1]
            with open(out, "wb"):
                pass
            self.returncode = 1 if cmd[-1].endswith("fhn_sens.cu") else 0

        def communicate(self):
            return ("error: a stand-in failure" if self.returncode else "ptxas info", None)

    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", Nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed on fhn_sens.cu"):
        _build.build()
    assert sorted(p.name for p in _build.library_dir().iterdir()) == ["ptxas.log"]


# -- what the wrappers hand to the launch ---------------------------------------


@pytest.fixture
def recorded_launches(monkeypatch):
    """The wrappers with the card patched away: CPU tensors pass the device
    check, the library is a stand-in and ``_launch`` records its operands."""
    seen = []
    monkeypatch.setattr(hl, "_KERNEL_DEVICE", "cpu")
    monkeypatch.setattr(hl, "_lib", lambda: types.SimpleNamespace(rhmc_cholesky="k1", rhmc_chol_solve_logdet="k2",
                                                                   rhmc_chol_inv_logdet="k3"))
    monkeypatch.setattr(hl, "_launch", lambda name, fn, tensors, c, d: seen.append((name, fn, tensors, c, d)))
    return seen


def strided(t):
    """The same values in storage with a gap after every row (not contiguous)."""
    wide = torch.zeros((*t.shape[:-1], t.shape[-1] + 2))
    wide[..., : t.shape[-1]] = t
    out = wide[..., : t.shape[-1]]
    assert not out.is_contiguous() and torch.equal(out, t)
    return out


# K1, and K3 (the same operand, three outputs), with the caller's G contiguous or strided.
@pytest.mark.parametrize("kernel,g_strided", [("cholesky", False), ("cholesky", True),
                                              ("chol_inv_logdet", False), ("chol_inv_logdet", True)],
                         ids=["contiguous", "strided", "chol_inv_logdet-contiguous", "chol_inv_logdet-strided"])
def test_torch_cholesky_cuda_hands_over_the_callers_operand(recorded_launches, kernel, g_strided):
    g, _ = spd(6, 5, seed=11)
    g = strided(torch.from_numpy(g)) if g_strided else torch.from_numpy(g)
    out = hl.cholesky_cuda(g) if kernel == "cholesky" else hl.chol_inv_logdet_cuda(g)
    outs = (out,) if kernel == "cholesky" else out
    ((name, fn, (g_seen, *seen), c, d),) = recorded_launches  # one launch
    assert (name, fn, c, d) == (kernel, {"cholesky": "k1", "chol_inv_logdet": "k3"}[kernel], 6, 5)
    assert g_seen.is_contiguous() and torch.equal(g_seen, g)
    assert (g_seen.data_ptr() == g.data_ptr()) == (not g_strided)  # no copy unless it must
    assert len(seen) == len(outs) and all(s is o and o.is_contiguous() for s, o in zip(seen, outs))
    assert [tuple(o.shape) for o in outs] == [(6, 5, 5), (6, 5, 5), (6,)][: len(outs)]


@pytest.mark.parametrize("g_strided,b_strided", [(False, False), (True, False), (False, True), (True, True)])
def test_torch_chol_solve_logdet_cuda_hands_over_the_callers_operands(recorded_launches, g_strided, b_strided):
    g, b = spd(6, 5, seed=12)
    g = strided(torch.from_numpy(g)) if g_strided else torch.from_numpy(g)
    b = strided(torch.from_numpy(b)) if b_strided else torch.from_numpy(b)
    x, logdet = hl.chol_solve_logdet_cuda(g, b)
    ((name, fn, (g_seen, b_seen, x_seen, ld_seen), c, d),) = recorded_launches
    assert (name, fn, c, d) == ("chol_solve_logdet", "k2", 6, 5)
    for seen, given, was_strided in ((g_seen, g, g_strided), (b_seen, b, b_strided)):
        assert seen.is_contiguous() and torch.equal(seen, given)
        assert (seen.data_ptr() == given.data_ptr()) == (not was_strided)
    assert x_seen is x and x.is_contiguous() and x.shape == (6, 5)
    assert ld_seen is logdet and logdet.shape == (6,)


def test_torch_cuda_wrappers_launch_nothing_on_an_empty_batch(recorded_launches):
    g, b = torch.zeros((0, 5, 5)), torch.zeros((0, 5))
    assert hl.cholesky_cuda(g).shape == (0, 5, 5)
    x, logdet = hl.chol_solve_logdet_cuda(g, b)
    assert x.shape == (0, 5) and logdet.shape == (0,)
    assert [tuple(o.shape) for o in hl.chol_inv_logdet_cuda(g)] == [(0, 5, 5), (0, 5, 5), (0,)]
    assert recorded_launches == []


# K3 takes what K1 takes: (argument, error, message) it refuses.
K3_REFUSES = {
    "k3-dtype": (torch.zeros((4, 5, 5), dtype=torch.float64), TypeError, "float32"),
    "k3-shape": (torch.zeros((4, 5, 6)), ValueError, r"\(C, D, D\)"),
    "k3-width": (torch.zeros((2, 49, 49)), ValueError, "D <= 48"),
}


@pytest.mark.parametrize("bad", ["dtype", "shape", "width", "rhs", *K3_REFUSES])
def test_torch_cuda_wrappers_refuse_what_the_kernels_do_not_take(recorded_launches, bad):
    g, b = torch.zeros((4, 5, 5)), torch.zeros((4, 5))
    if bad in K3_REFUSES:
        arg, err, match = K3_REFUSES[bad]
        with pytest.raises(err, match=match):
            hl.chol_inv_logdet_cuda(arg)
    elif bad == "dtype":
        with pytest.raises(TypeError, match="float32"):
            hl.cholesky_cuda(g.double())
    elif bad == "shape":
        with pytest.raises(ValueError, match=r"\(C, D, D\)"):
            hl.cholesky_cuda(torch.zeros((4, 5, 6)))
    elif bad == "width":
        with pytest.raises(ValueError, match="D <= 48"):
            hl.cholesky_cuda(torch.zeros((2, 49, 49)))
    else:
        with pytest.raises(ValueError, match="rhs"):
            hl.chol_solve_logdet_cuda(g, b[:, :4])
    assert recorded_launches == []


# -- the launch geometry, mirrored from the CUDA source ---------------------------


@pytest.mark.parametrize("d", range(1, hl.MAX_DIM + 1))
def test_torch_launch_geometry_covers_every_width(d):
    geo = hl.launch_geometry(d)
    assert geo.lanes_per_chain in (4, 8, 16, 32)  # a power of two, inside a warp
    assert geo.rows_per_lane in (1, 2) and geo.lanes_per_chain * geo.rows_per_lane >= d  # every row has a lane
    assert geo.chains_per_block * geo.lanes_per_chain == hl.THREADS_PER_BLOCK
    assert geo.chains_per_block % 4 == 0  # a block's run of G starts 16-byte aligned when G does
    assert geo.row_stride % 2 == 1 and d <= geo.row_stride <= d + 1  # odd: no bank conflicts
    assert geo.shared_bytes == 4 * geo.chains_per_block * d * geo.row_stride <= hl.STATIC_SHARED_LIMIT


def test_torch_launch_geometry_main_path_widths():
    """The widths the main paths run: StochVol's hyper block, australian, german."""
    assert hl.launch_geometry(3) == (4, 1, 32, 3, 1152)
    assert hl.launch_geometry(15) == (16, 1, 8, 15, 7200)
    assert hl.launch_geometry(25) == (32, 1, 4, 25, 10000)
    assert hl.launch_geometry(48) == (32, 2, 4, 49, 37632)
    for d in (0, 49):
        with pytest.raises(ValueError, match="D <= 48"):
            hl.launch_geometry(d)


def test_torch_launch_geometry_mirrors_the_cuda_source():
    """The widths, capacities, block size and lane rule read from hopper_linalg.cu and the header it shares
    with K4 (chol_rows.cuh: the layout, the factor and the substitutions)."""
    src = (_build.CSRC_DIR / "hopper_linalg.cu").read_text()
    assert '#include "chol_rows.cuh"' in src
    src += (_build.CSRC_DIR / "chol_rows.cuh").read_text()
    exact = [(int(a), int(b)) for a, b in re.findall(r"case (\d+): return f\(Width<(\d+), true>", src)]
    assert all(a == b for a, b in exact) and tuple(a for a, _ in exact) == hl.EXACT_WIDTHS
    caps = [(int(a), int(b)) for a, b in re.findall(r"if \(d <= (\d+)\) return f\(Width<(\d+), false>", src)]
    assert all(a == b for a, b in caps)
    assert tuple(a for a, _ in caps) + (hl.MAX_DIM,) == hl.CAPACITIES and "Width<kMaxDim, false>" in src
    assert f"constexpr int kMaxDim = {hl.MAX_DIM};" in src
    assert f"constexpr int kThreads = {hl.THREADS_PER_BLOCK};" in src
    assert "return n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : 32;" in src  # lanes_for
    assert "constexpr int row_stride(int d) { return d | 1; }" in src
    assert "permute" not in src and src.count("__global__") == 3  # one kernel template per function: K1, K2, K3
    # K1 and K2 launch a block a tile of launch_geometry's chains; K3 launches its own grid of warps that walk
    # tiles (k3_blocks), each block as k3_geometry lays it out, with the same widths.
    for kernel in ("cholesky_kernel", "chol_solve_logdet_kernel"):
        assert re.search(rf"{kernel}<W>\s*<<<blocks_for<W>\(num_chains\), kThreads, tile_bytes<W>\(d\),", src), kernel
    assert re.search(r"chol_inv_logdet_kernel<W><<<k3_blocks<W>\(num_chains\), K3<W>::kThreads, K3<W>::kSharedBytes,",
                     src)
    for line in ("static constexpr int kChains = 32 / W::kLanes;",
                 "static constexpr int kPad = ((kN + 3) / 4 | 1) * 4;",
                 "static constexpr int kChainStride = kN * kPad / 4 % 2 ? kN * kPad : kN * kPad + 4;",
                 "static constexpr int kStage = (kChains * kN * kN + 6) / 4 * 4;",
                 f"static constexpr int kWarpFloats = {hl.K3_STAGES} * kStage + kChains * kChainStride;",
                 "static constexpr int kWarps = kK3SharedFloats / kWarpFloats < 4 ? kK3SharedFloats / kWarpFloats : 4;",
                 "static constexpr int kSharedBytes = 4 * kWarps * kWarpFloats;",
                 f"constexpr int kK3SharedFloats = {hl.STATIC_SHARED_LIMIT // 1024} * 1024 / 4;",
                 "const int tiles = (num_chains + T::kChains - 1) / T::kChains, per_block = T::kWarps;",
                 "const int wanted = (tiles + per_block - 1) / per_block, resident = k3_resident_blocks<W>();",
                 "for (int buf = 0; tile < tiles; tile += stride, buf ^= 1) {",
                 "stride = gridDim.x * T::kWarps;", "int tile = blockIdx.x * T::kWarps + warp;"):
        assert line in src, line
    # K1, K2, K3, and the queries of K1 / K2's geometry, K3's geometry and K3's grid
    assert src.count("return with_width(d, [&](auto width) {") == 6


# -- K3's layout and walk, mirrored from the CUDA source ----------------------------


@pytest.mark.parametrize("d", range(1, hl.MAX_DIM + 1))
def test_torch_k3_geometry_covers_every_width(d):
    geo, k1 = hl.k3_geometry(d), hl.launch_geometry(d)
    n = d if d in hl.EXACT_WIDTHS else next(cap for cap in hl.CAPACITIES if d <= cap)  # rows unrolled for
    assert (geo.lanes_per_chain, geo.rows_per_lane) == k1[:2]  # K1's lanes and rows, so K1's factor
    assert geo.chains_per_warp * geo.lanes_per_chain == 32  # a tile is one warp's
    assert 1 <= geo.warps_per_block <= 4 and geo.shared_bytes <= hl.STATIC_SHARED_LIMIT  # no opt-in needed
    # L^T's rows and chains start 16-byte aligned (float4 reads), each an odd number of 16-byte slots long
    assert geo.row_stride % 4 == 0 and geo.row_stride // 4 % 2 == 1 and n <= geo.row_stride < n + 8
    assert geo.chain_stride % 4 == 0 and geo.chain_stride // 4 % 2 == 1 and geo.chain_stride >= n * geo.row_stride
    # Bank mapping: the broadcast float4 of each chain of a warp lies in its own 16-byte slot of 128 bytes.
    slots = {c * geo.chain_stride // 4 % 8 for c in range(geo.chains_per_warp)}
    assert len(slots) == geo.chains_per_warp
    # A stage holds a tile's run at any alignment (shift < 4) and keeps the next stage 16-byte aligned.
    assert geo.stage_floats % 4 == 0 and geo.stage_floats >= geo.chains_per_warp * d * d + 3
    warp_floats = hl.K3_STAGES * geo.stage_floats + geo.chains_per_warp * geo.chain_stride
    assert geo.shared_bytes == 4 * geo.warps_per_block * warp_floats
    assert (geo.warps_per_block == 4 or 4 * (geo.warps_per_block + 1) * warp_floats > hl.STATIC_SHARED_LIMIT)


def test_torch_k3_fallback_widths_reach_every_instantiation():
    """chip_smoke.py runs K3's exact factor once at each instantiation that a width reaches (``with_width``)."""
    reached = {d if d in hl.EXACT_WIDTHS else next(cap for cap in hl.CAPACITIES if d <= cap)
               for d in range(1, hl.MAX_DIM + 1)}
    covered = {d if d in hl.EXACT_WIDTHS else next(cap for cap in hl.CAPACITIES if d <= cap)
               for d in chip_smoke.K3_FALLBACK_WIDTHS}
    assert covered == reached


@pytest.mark.parametrize("d", [2, 3, 15, 25, 40, 48])
@pytest.mark.parametrize("c", [1, 2, 7, 255, 4096, 4097, 33792])
def test_torch_k3_schedule_covers_every_chain_once(c, d):
    """K3's walk from the mirror: every chain in one warp's tile once, at any grid; every copy of a tile
    (G at each alignment, L and G^-1) 16-byte chunks at 16-byte aligned starts, 4-byte copies at its ends."""
    geo = hl.k3_geometry(d)
    tiles = -(-c // geo.chains_per_warp)
    for resident in (132 * 16, 132, 3):  # blocks a card holds at once: many, one an SM, few (warps walk far)
        blocks = hl.k3_blocks(c, d, resident)
        assert 1 <= blocks <= resident and (blocks == resident or blocks * geo.warps_per_block >= tiles)
        walks = hl.k3_schedule(c, d, blocks)
        assert len(walks) == blocks * geo.warps_per_block
        owned = [chain for walk in walks for tile in walk
                 for chain in range(tile * geo.chains_per_warp, min(c, (tile + 1) * geo.chains_per_warp))]
        assert sorted(owned) == list(range(c))
        assert all(b - a == len(walks) for walk in walks for a, b in zip(walk, walk[1:]))
    for tile in {0, 1, 2, tiles // 2, tiles - 2, tiles - 1} & set(range(tiles)):
        here = min(geo.chains_per_warp, c - tile * geo.chains_per_warp)
        first, count = tile * geo.chains_per_warp * d * d, here * d * d
        for shift in range(4):  # the operand's data this many floats past a 16-byte boundary
            cp = hl.k3_copy(first, count, shift)
            assert cp.head + 4 * cp.chunks + cp.tail == count and cp.head < 4 and cp.tail < 4
            assert cp.chunks == 0 or (shift + first + cp.head) % 4 == 0  # 16-byte chunks start 16-byte aligned
            assert cp.head == 0 or (shift + first) % 4 != 0  # the 4-byte path only off a boundary, or at the end
            assert (shift + first) % 4 + count <= geo.stage_floats  # the image fits its stage


# -- K3's inverse in its own order ----------------------------------------------------


def test_torch_fma32_rounds_once():
    """The replay's fused multiply-add: a * b + c rounded once to float32 (exact rationals decide), near
    cancellation too."""
    from fractions import Fraction

    rng = np.random.default_rng(11)
    a, b = rng.normal(size=(2, 3000)).astype(np.float32)
    c = (-(a.astype(np.float64) * b) * (1 + rng.normal(size=3000) * 1e-6)).astype(np.float32)
    c[::3] = rng.normal(size=1000).astype(np.float32)
    got = hl._fma32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    for x, y, z, r in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        err = abs(Fraction(float(r)) - exact)
        for other in (np.nextafter(r, np.float32(np.inf)), np.nextafter(r, np.float32(-np.inf))):
            other_err = abs(Fraction(float(other)) - exact)
            assert err < other_err or (err == other_err and int(r.view(np.int32)) % 2 == 0)


# K3 multiplies by a reciprocal where the twin divides (ops/hopper_linalg.py::inv_in_kernel_order replays it):
# against the JAX package's geometry with chip_smoke.py's tolerances.
@pytest.mark.parametrize("c,d", [(64, 3), (40, 15), (24, 25), (9, 40)])
def test_torch_k3_inverse_order_matches_the_jax_geometry(c, d):
    g, _ = spd(c, d, seed=7 * c + d)
    l_ref = jops.cholesky(jnp.asarray(g), method="unrolled")
    inv_ref = np.asarray(jops.inv_psd_from_chol(l_ref, method="unrolled"))
    l = hl.cholesky_plain(torch.from_numpy(g))
    np.testing.assert_allclose(l.numpy(), np.asarray(l_ref), rtol=1e-5, atol=1e-5)
    inv = hl.inv_in_kernel_order(l)
    rtol, atol = chip_smoke.TOL["inv"]
    np.testing.assert_allclose(inv.numpy(), inv_ref, rtol=rtol, atol=atol)
    assert torch.equal(inv, inv.mT)  # (a, b) and (b, a): the same products in the same order
    half = 0.5 * np.asarray(jops.logdet_from_chol(l_ref))
    np.testing.assert_allclose(hl.chol_inv_logdet_plain(torch.from_numpy(g))[2].numpy(), half, rtol=2e-4, atol=2e-3)


def test_torch_k3_inverse_order_on_ill_conditioned_metrics():
    """3 x 3 metrics shaped like FHN's (entries to ~1e4, condition numbers to ~1e5): each chain's inverse
    within chip_smoke.INV_COND_TOL x its condition number of the JAX geometry's, relative to its largest entry."""
    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.normal(size=(256, 3, 3)))
    lam = 10.0 ** rng.uniform(0.0, 5.0, size=(256, 3))
    g = ((q * lam[:, None, :]) @ np.swapaxes(q, -1, -2)).astype(np.float32)
    g = 0.5 * (g + np.swapaxes(g, -1, -2))
    cond = np.linalg.cond(g.astype(np.float64))
    assert cond.max() > 1e4
    l_ref = jops.cholesky(jnp.asarray(g), method="unrolled")
    inv_ref = np.asarray(jops.inv_psd_from_chol(l_ref, method="unrolled")).astype(np.float64)
    inv = hl.inv_in_kernel_order(hl.cholesky_plain(torch.from_numpy(g))).numpy().astype(np.float64)
    rel = np.abs(inv - inv_ref).reshape(256, -1).max(1) / np.abs(inv_ref).reshape(256, -1).max(1)
    assert (rel <= chip_smoke.INV_COND_TOL * cond).all(), float((rel / cond).max())


# -- chip_smoke.py's bound ---------------------------------------------------------


# Bytes each kernel must move (inputs read once, outputs written once) over
# 3.35 TB/s, in microseconds, worked out by hand for the timed shapes.
@pytest.mark.parametrize("name,c,d,expected_us", [
    ("cholesky", 4096, 15, 2 * 4096 * 225 * 4 / 3.35e6),  # 7.37 MB -> 2.2 us
    ("cholesky", 4096, 25, 20_480_000 / 3.35e6),  # 6.11 us
    ("cholesky", 4096, 3, 294_912 / 3.35e6),
    ("cholesky", 1024, 3, 73_728 / 3.35e6),
    ("cholesky", 256, 3, 18_432 / 3.35e6),  # FHN's metric
    ("chol_solve_logdet", 4096, 15, (3_686_400 + 245_760 + 245_760 + 16_384) / 3.35e6),  # 4.19 MB -> 1.25 us
    ("chol_solve_logdet", 4096, 25, 11_075_584 / 3.35e6),  # 3.31 us
    ("chol_solve_logdet", 4096, 3, 262_144 / 3.35e6),
    ("chol_solve_logdet", 1024, 3, 65_536 / 3.35e6),
    ("chol_solve_logdet", 256, 3, 16_384 / 3.35e6),
    ("chol_inv_logdet", 4096, 15, (3 * 4096 * 225 + 4096) * 4 / 3.35e6),  # G in, L and G^-1 out: 11.1 MB -> 3.3 us
    ("chol_inv_logdet", 4096, 25, (3 * 4096 * 625 + 4096) * 4 / 3.35e6),  # 9.2 us
    ("chol_inv_logdet", 1024, 3, (3 * 1024 * 9 + 1024) * 4 / 3.35e6),
    ("chol_inv_logdet", 4, 2, (3 * 4 * 4 + 4) * 4 / 3.35e6),
    ("cholesky", 8192, 15, 2 * 8192 * 225 * 4 / 3.35e6),  # australian at the bench's second chain count: 4.4 us
    ("chol_solve_logdet", 8192, 15, (7_372_800 + 491_520 + 491_520 + 32_768) / 3.35e6),  # 2.5 us
    ("chol_inv_logdet", 8192, 15, (3 * 8192 * 225 + 8192) * 4 / 3.35e6),  # 22.1 MB -> 6.6 us
])
def test_torch_chip_smoke_bound_us(name, c, d, expected_us):
    assert (c, d) in chip_smoke.TIMED_SHAPES
    us, bound_by = chip_smoke.bound_us(name, c, d)
    assert us == pytest.approx(expected_us, rel=1e-12) and bound_by == "bytes"
