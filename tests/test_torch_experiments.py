"""Port parity: the BLR experiment layer, its presets and its CLI.

No BLR CSV ships with the repository, so the module writes a synthetic one
of australian's shape (14 feature columns and a 0/1 label) and points both
packages' loaders at it.  Runs are small (16-64 chains, tens of samples) on
the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import riemannhamiltonianmontecarlo_tpu.experiments as jexp
import riemannhamiltonianmontecarlo_tpu.models.datasets as jdatasets
import riemannhamiltonianmontecarlo_tpu.utils.config as jconfig
import riemannhamiltonianmontecarlo_tpu_torch.models.datasets as tdatasets
import riemannhamiltonianmontecarlo_tpu_torch.utils.config as tconfig
from riemannhamiltonianmontecarlo_tpu_torch import experiments, interop

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def australian_csv(tmp_path_factory):
    ds = tdatasets.synthetic_logreg(seed=0, n=200, d=15)
    data = tmp_path_factory.mktemp("data")
    np.savetxt(data / "australian.csv", np.column_stack([ds.X[:, 1:], ds.t]), delimiter=",")
    with pytest.MonkeyPatch.context() as mp:
        for module in (jdatasets, tdatasets):
            mp.setattr(module, "_SEARCH_PATHS", (str(data),))
        yield data


def test_torch_presets_equal_jax():
    assert tconfig._BLR_PRESETS == jconfig._BLR_PRESETS
    assert tconfig.HMC_STEP_SIZES == jconfig.HMC_STEP_SIZES
    assert tconfig.MALA_STEP_SIZES == jconfig.MALA_STEP_SIZES
    assert tconfig.MALA_TRANSIENT_FACTOR == jconfig.MALA_TRANSIENT_FACTOR
    assert experiments.SAMPLERS == jexp.SAMPLERS
    for sampler in experiments.SAMPLERS:
        for dataset in tdatasets.DATASET_SPECS:
            assert dataclasses.asdict(tconfig.reference_preset(sampler, dataset)) == dataclasses.asdict(
                jconfig.reference_preset(sampler, dataset))


def test_torch_loader_reads_the_csv_as_jax_does():
    t, j = tdatasets.load_dataset("australian"), jdatasets.load_dataset("australian")
    assert t.X.shape == (200, 15)
    np.testing.assert_array_equal(t.X, j.X)
    np.testing.assert_array_equal(t.t, j.t)


@pytest.mark.parametrize("name", experiments.SAMPLERS)
def test_torch_build_kernel_every_sampler(name):
    ds = tdatasets.synthetic_logreg(seed=1, n=40, d=4)
    model = interop.logreg_from_numpy(ds.X, ds.t, device="cpu")
    kernel, warm = experiments.build_kernel(name, model, "australian", None)
    assert (warm is not None) == (name == "mala")
    gen = torch.Generator().manual_seed(0)
    state = (warm or kernel).init(torch.zeros(3, 4) + 0.01)
    state, info = kernel.step(gen, state)
    assert state.position.shape == (3, 4) and info.accept_prob.shape == (3,)
    if name in ("hmc", "mala", "mmala", "mmala_simplified", "rmhmc", "rmhmc_studentt"):
        build_fn, cfg, target = experiments.adaptive_parts(name, "australian")
        jfn, jcfg, jtarget = jexp.adaptive_parts(name, "australian")
        assert target == jtarget and cfg.step_size == jcfg.step_size
    else:
        with pytest.raises(KeyError):
            experiments.adaptive_parts(name, "australian")


def test_torch_run_experiment_result_and_summary_match_jax():
    res = experiments.run_experiment(
        "hmc", "australian", device="cpu", num_chains=16, num_samples=40, burn_in=20,
        sampler_overrides={"num_leapfrog": 10, "step_size": 0.1}, keep_samples=True,
    )
    assert [f.name for f in dataclasses.fields(res)] == [f.name for f in dataclasses.fields(jexp.ExperimentResult)]
    assert res.num_samples == 40 and res.samples.shape == (16, 40, 15)
    assert res.ess_min > 0 and res.sampling_time_s > 0 and np.isfinite(res.posterior_mean).all()
    assert res.time_per_min_ess == pytest.approx(res.sampling_time_s / res.ess_min)
    assert 0.0 < res.accept_rate <= 1.0 and res.divergences == 0
    assert res.summary() == jexp.ExperimentResult(**dataclasses.asdict(res)).summary()
    assert res.summary().startswith("hmc on australian: 16 chains x 40 samples")


def test_torch_run_experiment_adapt_mala():
    """--adapt: dual averaging replaces the hand-tuned step and lands near
    0.574 (the JAX test's tolerance, tests/test_experiments.py:50-59)."""
    res = experiments.run_experiment("mala", "australian", device="cpu", num_chains=64, num_samples=200,
                                     burn_in=300, adapt=True)
    assert res.adapted_step_size is not None and res.adapted_step_size > 0
    assert abs(res.accept_rate - 0.574) < 0.12, (res.accept_rate, res.adapted_step_size)
    assert np.isfinite(res.posterior_mean).all()


def test_torch_ess_mode_device_matches_exact():
    kw = dict(device="cpu", num_chains=16, num_samples=60, burn_in=20, seed=3,
              sampler_overrides={"num_leapfrog": 10, "step_size": 0.1})
    exact = experiments.run_experiment("hmc", "australian", ess_mode="exact", **kw)
    dev = experiments.run_experiment("hmc", "australian", ess_mode="device", **kw)
    # the same seed on the CPU: the same chains; float32 FFT against float64
    for stat in ("ess_min", "ess_median", "ess_mean", "ess_max", "rhat_max", "geweke_max_abs_z"):
        assert getattr(dev, stat) == pytest.approx(getattr(exact, stat), rel=1e-3), stat
    np.testing.assert_allclose(dev.posterior_mean, exact.posterior_mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dev.posterior_std, exact.posterior_std, rtol=1e-4)


def test_torch_run_repeated_aggregates():
    results, agg = experiments.run_repeated(
        "mala", "australian", n_repeats=2, device="cpu", num_chains=8, num_samples=30, burn_in=10)
    assert len(results) == 2 and results[0].posterior_mean is not results[1].posterior_mean
    mean, stderr = agg["ess_min"]
    assert mean > 0 and stderr >= 0
    assert set(agg) == {"ess_min", "ess_median", "ess_mean", "ess_max", "sampling_time_s", "time_per_min_ess", "accept_rate"}


def test_torch_cli_runs_on_cpu(capsys):
    experiments.main(["--sampler", "mmala", "--device", "cpu", "--chains", "8", "--samples", "20", "--burn-in", "10"])
    out = capsys.readouterr().out
    assert out.startswith("mmala on australian: 8 chains x 20 samples")


def test_torch_native_ess_mode_matches_exact():
    """ess_mode="native" (the C++ engine, exact ACF) on the same chains as "exact"."""
    kw = dict(device="cpu", num_chains=16, num_samples=40, burn_in=10,
              sampler_overrides={"num_leapfrog": 10, "step_size": 0.1})
    exact = experiments.run_experiment("hmc", "australian", ess_mode="exact", **kw)
    native = experiments.run_experiment("hmc", "australian", ess_mode="native", **kw)
    for stat in ("ess_min", "ess_median", "ess_mean", "ess_max"):
        assert getattr(native, stat) == pytest.approx(getattr(exact, stat), rel=1e-10), stat
    np.testing.assert_array_equal(native.posterior_mean, exact.posterior_mean)


def test_torch_refusals(monkeypatch, capsys):
    with pytest.raises(ValueError, match="ess_mode must be one of"):
        experiments.run_experiment("hmc", "australian", device="cpu", ess_mode="fast")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        experiments.run_experiment("hmc", "australian", device="cuda")
    for argv in (["--device", "cuda"], ["--workload", "fhn", "--sampler", "gibbs", "--device", "cpu"]):
        with pytest.raises(SystemExit) as exit_info:
            experiments.main(argv)
        assert exit_info.value.code != 0
    err = capsys.readouterr().err
    assert "is_available() is False" in err and "not available for workload" in err
