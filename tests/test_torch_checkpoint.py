"""Port: checkpoint round trip and bit-exact resume (``utils.checkpoint``, ``run_checkpointed``).

The four cases of ``tests/test_checkpoint.py`` on the port's HMC over a
small synthetic logistic regression (CPU), then what the port adds: nested
state trees, a ``torch.Generator``'s state in place of the JAX key, the
file layout shared with the JAX package's ``save_state``, and the joint LGC
sampler (the run the tool resumes) through ``run_checkpointed``.
Everything compared here is compared for equality, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import riemannhamiltonianmontecarlo_tpu_torch as rt
from riemannhamiltonianmontecarlo_tpu.utils import checkpoint as jckpt
from riemannhamiltonianmontecarlo_tpu_torch.parallel import run, run_checkpointed, segment_generator
from riemannhamiltonianmontecarlo_tpu_torch.samplers import hmc, lgc_joint, rmhmc
from riemannhamiltonianmontecarlo_tpu_torch.utils.checkpoint import (
    checkpoint_exists,
    load_state,
    save_state,
    tree_leaves,
    tree_unflatten,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    ds = rt.models.synthetic_logreg(seed=0, n=40, d=3)
    return rt.interop.logreg_from_numpy(ds.X, ds.t, device="cpu")


@pytest.fixture()
def kernel(model):
    return hmc.build(model, hmc.HMCConfig(step_size=0.1, num_leapfrog=5))


def test_torch_checkpoint_roundtrip_resume(tmp_path, kernel):
    init = torch.zeros((16, 3))
    gen = torch.Generator().manual_seed(0)
    # One continuous run...
    mid = run(kernel, gen, init, num_samples=20, burn_in=0)
    path = tmp_path / "ckpt.npz"
    save_state(path, mid.final_state, step=20, generator=gen)  # ...saved at the midpoint...
    full = run(kernel, gen, None, num_samples=30, burn_in=0, init_state=mid.final_state)

    # ...vs restore into a fresh template and generator.
    assert checkpoint_exists(path) and not checkpoint_exists(tmp_path / "none.npz")
    assert not (tmp_path / "ckpt.npz.tmp").exists()
    restored, step, gen_state = load_state(path, kernel.init(init))
    assert step == 20 and type(restored) is type(mid.final_state)
    for a, b in zip(tree_leaves(restored), tree_leaves(mid.final_state)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    gen2 = torch.Generator()
    gen2.set_state(gen_state)
    resumed = run(kernel, gen2, None, num_samples=30, burn_in=0, init_state=restored)
    assert torch.equal(full.samples, resumed.samples)
    assert load_state(path, kernel.init(init))[2] is not None
    save_state(path, mid.final_state)  # no generator, step 0
    assert load_state(path, kernel.init(init))[1:] == (0, None)


def test_torch_run_checkpointed_crash_resume_bit_exact(tmp_path, kernel):
    """A run killed mid-way resumes from the last segment and produces
    samples bit-identical to the uninterrupted segmented run."""
    init = torch.zeros((16, 3))
    kw = dict(num_samples=50, burn_in=10, checkpoint_every=10)
    full = run_checkpointed(kernel, 7, init, checkpoint_path=tmp_path / "a" / "ckpt.npz", **kw)
    assert full.samples.shape == (16, 50, 3) and 0.0 < float(full.accept_rate) <= 1.0

    # Simulated crash after 2 of 5 segments...
    crashed = run_checkpointed(kernel, 7, init, checkpoint_path=tmp_path / "b" / "ckpt.npz",
                               _stop_after_segments=2, **kw)
    assert crashed.samples.shape == (16, 20, 3)
    assert torch.equal(crashed.samples, full.samples[:, :20])
    # ...then a plain re-invocation resumes from segment 2.
    resumed = run_checkpointed(kernel, 7, init, checkpoint_path=tmp_path / "b" / "ckpt.npz", **kw)
    assert torch.equal(full.samples, resumed.samples)
    assert torch.equal(full.final_state.position, resumed.final_state.position)
    assert int(resumed.divergences) == 0
    # another seed is another run; the same seed in plain segments is this one
    other = run_checkpointed(kernel, 8, init, checkpoint_path=tmp_path / "c" / "ckpt.npz", **kw)
    assert not torch.equal(other.samples, full.samples)
    state = run(kernel, segment_generator(7, 0, "cpu"), init, num_samples=0, burn_in=10, collect=False).final_state
    by_hand = run(kernel, segment_generator(7, 1, "cpu"), None, num_samples=10, init_state=state)
    assert torch.equal(by_hand.samples, full.samples[:, :10])


def test_torch_run_checkpointed_collect_fn_tree(tmp_path, kernel):
    """Segments of a non-trivial collect_fn tree reassemble correctly (25 = 10 + 10 + 5)."""
    res = run_checkpointed(kernel, 1, torch.zeros((8, 3)), num_samples=25, burn_in=5,
                           checkpoint_path=tmp_path / "ckpt.npz", checkpoint_every=10,
                           collect_fn=lambda st: (st.position, {"first": st.position[:, 0]}))
    a, b = res.samples
    assert a.shape == (8, 25, 3) and b["first"].shape == (8, 25)
    assert torch.equal(a[:, :, 0], b["first"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt.npz", "ckpt.npz.seg0", "ckpt.npz.seg1", "ckpt.npz.seg2"]


def test_torch_checkpoint_shape_mismatch_raises(tmp_path, kernel):
    path = tmp_path / "ckpt.npz"
    save_state(path, kernel.init(torch.zeros((8, 3))))
    with pytest.raises(ValueError, match="shape"):
        load_state(path, kernel.init(torch.zeros((4, 3))))


def test_torch_checkpoint_nested_state_tree(tmp_path, model):
    """An RMHMC state carries its geometry, a NamedTuple inside a NamedTuple;
    None leaves (a state whose geometry is rebuilt lazily) are structure, not data."""
    kern = rmhmc.build(model)
    state = kern.init(0.1 * torch.ones((4, 3)))
    assert len(tree_leaves(state)) == 2 + len(state.geo)
    path = tmp_path / "rmhmc.npz"
    save_state(path, state, step=3)
    back, step, _ = load_state(path, kern.init(torch.zeros((4, 3))))
    assert step == 3 and type(back.geo) is type(state.geo)
    for a, b in zip(tree_leaves(back), tree_leaves(state)):
        assert torch.equal(a, b)
    bare = rmhmc.RMHMCState(state.position, state.logp, None)
    assert len(tree_leaves(bare)) == 2
    assert tree_unflatten(bare, [state.logp, state.position]).geo is None
    with pytest.raises(ValueError, match="more leaves"):
        tree_unflatten(bare, tree_leaves(state))
    # a step from the restored state is the step from the saved one
    s1, _ = kern.step(torch.Generator().manual_seed(5), state)
    s2, _ = kern.step(torch.Generator().manual_seed(5), back)
    assert torch.equal(s1.position, s2.position)


def test_torch_checkpoint_file_layout_is_the_jax_packages(tmp_path, kernel):
    """One ``.npz`` with ``leaf_<i>`` in tree order and ``__step__``: a state
    saved by the JAX package's ``save_state`` loads into the port's template."""
    from riemannhamiltonianmontecarlo_tpu.samplers import hmc as jhmc

    rng = np.random.default_rng(2)
    jstate = jhmc.HMCState(jnp.asarray(rng.normal(size=(5, 3)), jnp.float32), jnp.asarray(rng.normal(size=5), jnp.float32))
    jckpt.save_state(tmp_path / "jax.npz", jstate, step=11)
    state, step, gen_state = load_state(tmp_path / "jax.npz", kernel.init(torch.zeros((5, 3))))
    assert step == 11 and gen_state is None
    np.testing.assert_array_equal(state.position.numpy(), np.asarray(jstate.position))
    np.testing.assert_array_equal(state.logp.numpy(), np.asarray(jstate.logp))
    save_state(tmp_path / "torch.npz", state, step=12)
    jback, jstep, _ = jckpt.load_state(tmp_path / "torch.npz", jstate)
    assert jstep == 12
    np.testing.assert_array_equal(np.asarray(jback.position), np.asarray(jstate.position))


def test_torch_run_checkpointed_lgc_joint_resume_bit_exact(tmp_path):
    """The joint LGC sampler (n = 6), its (hyper, latent) tree collected:
    stopped after one segment and resumed equals the run that was not stopped."""
    from riemannhamiltonianmontecarlo_tpu_torch import experiments

    kernel, init_fn, collect_fn, _, _ = experiments.build_workload("lgc", "rmhmc_joint", device="cpu", lgc_n=6)
    kw = dict(num_samples=9, burn_in=3, checkpoint_every=4, collect_fn=collect_fn)
    full = run_checkpointed(kernel, 0, init_fn(3), checkpoint_path=tmp_path / "a.npz", **kw)
    run_checkpointed(kernel, 0, init_fn(3), checkpoint_path=tmp_path / "b.npz", _stop_after_segments=1, **kw)
    resumed = run_checkpointed(kernel, 0, init_fn(3), checkpoint_path=tmp_path / "b.npz", **kw)
    assert full.samples[0].shape == (3, 9, 2) and full.samples[1].shape == (3, 9, 36)
    for a, b in zip(tree_leaves((full.samples, full.final_state)), tree_leaves((resumed.samples, resumed.final_state))):
        assert torch.equal(a, b)
    assert isinstance(resumed.final_state, lgc_joint.LGCJointState)
    assert int(resumed.divergences) == 0 and jax.__version__  # jax only as the reference in this file
