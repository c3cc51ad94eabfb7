"""Port parity: the PyTorch LogisticRegression against the JAX package's.

Same float32 inputs (``synthetic_logreg`` through numpy) into both models,
at D in {7, 15, 25} (ripley's, australian's and german's widths), with and
without a padding mask.  Tolerance: rtol 1e-4 with atol 1e-4 * max|ref|
per output -- float32 sums over N <= 690 rows taken in a different order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riemannhamiltonianmontecarlo_tpu.models import LogisticRegression as JaxLogisticRegression
from riemannhamiltonianmontecarlo_tpu_torch import interop
from riemannhamiltonianmontecarlo_tpu_torch.models import synthetic_logreg

torch.set_num_threads(1)

RTOL = 1e-4
CHAINS = 16


def assert_close(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.numpy(), ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


@pytest.fixture(scope="module", params=[(7, 250, False), (15, 690, False), (25, 690, False), (15, 690, True)],
                ids=["d7", "d15", "d25", "d15-mask"])
def pair(request):
    d, n, masked = request.param
    ds = synthetic_logreg(seed=d, n=n, d=d)
    x, t = ds.X.astype(np.float32), ds.t.astype(np.float32)
    mask = None
    if masked:  # zero rows as the JAX package's with_sharding pads them
        x = np.concatenate([x, np.zeros((10, d), np.float32)])
        t = np.concatenate([t, np.zeros(10, np.float32)])
        mask = np.concatenate([np.ones(n, np.float32), np.zeros(10, np.float32)])
    jm = JaxLogisticRegression(
        jnp.asarray(x), jnp.asarray(t), mask=None if mask is None else jnp.asarray(mask)
    )
    tm = interop.logreg_from_numpy(x, t, mask=mask, device="cpu")
    rng = np.random.default_rng(d + n)
    w = (0.3 * rng.normal(size=(CHAINS, d))).astype(np.float32)
    u = rng.normal(size=(CHAINS, d)).astype(np.float32)
    v = rng.normal(size=(CHAINS, d)).astype(np.float32)
    a = rng.normal(size=(CHAINS, d, d))
    m = (a @ np.swapaxes(a, -1, -2) / d + np.eye(d)).astype(np.float32)  # symmetric, like G^-1
    return jm, tm, w, u, v, m


def test_torch_logreg_densities(pair):
    jm, tm, w, *_ = pair
    wt = torch.from_numpy(w)
    assert_close(tm.logp(wt), jm.logp(jnp.asarray(w)))
    assert_close(tm.grad(wt), jm.grad(jnp.asarray(w)))
    assert_close(tm.log_prior(wt), jm.log_prior(jnp.asarray(w)))
    # one unbatched position, as map_estimate passes it
    assert_close(tm.logp(wt[0]), jm.logp(jnp.asarray(w[0])))


def test_torch_logreg_metric(pair):
    jm, tm, w, *_ = pair
    wt, wj = torch.from_numpy(w), jnp.asarray(w)
    assert_close(tm.metric(wt), jm.metric(wj))
    ms, jms = tm.manifold_state(wt), jm.manifold_state(wj)
    for name in ("logp", "grad", "metric", "cache"):
        assert_close(getattr(ms, name), getattr(jms, name))


def test_torch_logreg_dg_contractions(pair):
    jm, tm, w, u, v, m = pair
    wt, wj = torch.from_numpy(w), jnp.asarray(w)
    ut, uj = torch.from_numpy(u), jnp.asarray(u)
    vt, vj = torch.from_numpy(v), jnp.asarray(v)
    mt, mj = torch.from_numpy(m), jnp.asarray(m)
    assert_close(tm.dg_cache(wt), jm.dg_cache(wj))
    assert_close(tm.quadratic_forms(mt), jm.quadratic_forms(mj))
    assert_close(tm.dg_bilinear(wt, ut, vt), jm.dg_bilinear(wj, uj, vj))
    assert_close(tm.dg_bilinear(wt, ut, ut), jm.dg_bilinear(wj, uj, uj))
    cache = tm.dg_cache(wt)
    assert_close(tm.dg_trace(wt, mt, cache=cache), jm.dg_trace(wj, mj))
    assert_close(tm.dg_dotted(wt, mt), jm.dg_dotted(wj, mj))


def test_torch_logreg_mask_removes_padding():
    """A zero-padded, masked model has the unpadded model's logp, grad and G."""
    ds = synthetic_logreg(seed=1, n=120, d=7)
    x, t = ds.X.astype(np.float32), ds.t.astype(np.float32)
    xp = np.concatenate([x, np.zeros((8, 7), np.float32)])
    tp = np.concatenate([t, np.zeros(8, np.float32)])
    mask = np.concatenate([np.ones(120, np.float32), np.zeros(8, np.float32)])
    plain = interop.logreg_from_numpy(x, t, device="cpu")
    padded = interop.logreg_from_numpy(xp, tp, mask=mask, device="cpu")
    unmasked = interop.logreg_from_numpy(xp, tp, device="cpu")
    w = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 7)).astype(np.float32))
    torch.testing.assert_close(padded.logp(w), plain.logp(w), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(padded.grad(w), plain.grad(w), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(padded.metric(w), plain.metric(w), rtol=1e-5, atol=1e-5)
    # without the mask each padded row adds softplus(0) = log 2 to -logp
    torch.testing.assert_close(unmasked.logp(w), plain.logp(w) - 8 * np.log(2.0), rtol=1e-5, atol=1e-3)


def test_torch_logreg_buffers_follow_module():
    """X, t, the mask and the outer features are buffers: .to() moves and casts them."""
    ds = synthetic_logreg(seed=2, n=30, d=5)
    model = interop.logreg_from_numpy(ds.X, ds.t, alpha=10.0, mask=np.ones(30), device="cpu")
    assert set(dict(model.named_buffers())) == {"X", "t", "mask", "outer_features"}
    assert model.outer_features.shape == (30, 25)
    m64 = model.to(torch.float64)
    assert all(b.dtype == torch.float64 for b in m64.buffers())
    assert m64.dim == 5 and m64.alpha == 10.0
