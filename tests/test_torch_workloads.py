"""Port parity: the non-BLR workload entry point (``run_workload``) and ``--workload``.

Small runs on the CPU: stochastic volatility at T = 60 and log-Gaussian Cox
at n = 8, checking the ``WorkloadResult`` fields and the group shapes as
``tests/test_experiments.py:121-166`` does for the JAX package; the burn-in
of StochVol MALA stepped by its transient-phase kernel; the CLI's workload
choices and the samplers each workload refuses (FitzHugh-Nagumo itself is
in ``test_torch_fhn.py``, the joint LGC samplers in
``test_torch_lgc_joint.py``); ``load_data`` finding the authors' files.
"""

import dataclasses

import numpy as np
import pytest
import torch

import riemannhamiltonianmontecarlo_tpu.experiments as jexp
from riemannhamiltonianmontecarlo_tpu_torch import experiments
from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import Kernel

torch.set_num_threads(1)


def test_torch_workload_samplers_equal_jax():
    assert experiments.WORKLOAD_SAMPLERS == jexp.WORKLOAD_SAMPLERS


def test_torch_run_workload_stochvol_result_and_groups():
    res = experiments.run_workload("stochvol", "rmhmc", device="cpu", num_chains=6, num_samples=12, burn_in=4,
                                   stochvol_obs=60, keep_samples=True)
    jfields = [f.name for f in dataclasses.fields(jexp.WorkloadResult)]
    assert [f.name for f in dataclasses.fields(res)] == jfields + ["samples"]
    assert (res.workload, res.sampler, res.num_chains, res.num_samples) == ("stochvol", "rmhmc", 6, 12)
    assert set(res.ess) == set(res.rhat_max) == set(res.geweke_max_abs_z) == {"hyper", "latent"}
    assert res.ess["hyper"].shape == (3,) and res.ess["latent"].shape == (60,)
    assert res.samples["hyper"].shape == (6, 12, 3) and res.samples["latent"].shape == (6, 12, 60)
    assert np.isfinite(res.samples["hyper"]).all() and np.isfinite(res.samples["latent"]).all()
    hyper = res.samples["hyper"]
    assert (hyper[..., 0] > 0).all() and (hyper[..., 1] > 0).all() and (np.abs(hyper[..., 2]) < 1).all()
    assert 0.0 < res.accept_rate <= 1.0 and res.divergences >= 0 and res.sampling_time_s > 0
    assert res.summary().startswith("stochvol/rmhmc: 6 chains x 12 samples")
    # the summary is the JAX package's, line for line
    jres = jexp.WorkloadResult(**{k: v for k, v in dataclasses.asdict(res).items() if k != "samples"})
    assert res.summary() == jres.summary()


def test_torch_stochvol_mala_burn_in_steps_the_transient_kernel():
    """StochVol MALA's burn-in runs the transient-phase step sizes
    (StochVol_MALA.m:62-67) and sampling the stationary ones (:279-283).
    The JAX package's timed_sampling passes the warmup kernel but burns in
    with num_samples=burn_in and burn_in=0, so there the transient kernel
    only initializes the chains; the port steps it."""
    kernel, init_fn, collect_fn, _, warm = experiments.build_workload("stochvol", "mala", device="cpu",
                                                                      stochvol_obs=60)
    assert warm is not None and warm.step is not kernel.step
    calls = {"warm": 0, "main": 0}

    def counted(k: Kernel, name: str) -> Kernel:
        def step(gen, state):
            calls[name] += 1
            return k.step(gen, state)
        return Kernel(k.init, step, k.transition)

    samples, accept, div, seconds = experiments.timed_sampling(
        counted(kernel, "main"), init_fn(4), device=torch.device("cpu"), burn_in=7, num_samples=10,
        collect_fn=collect_fn, warmup_kernel=counted(warm, "warm"))
    assert calls == {"warm": 7, "main": 10}
    assert samples[0].shape == (4, 10, 3) and samples[1].shape == (4, 10, 60)
    assert 0.0 <= accept <= 1.0 and seconds > 0


@pytest.mark.parametrize("sampler", ["rmhmc", "mmala", "mala_transient", "mala_stationary"])
def test_torch_run_workload_lgc_small(sampler):
    res = experiments.run_workload("lgc", sampler, device="cpu", num_chains=4, num_samples=8, burn_in=4, lgc_n=8,
                                   keep_samples=True)
    assert set(res.ess) == {"latent"} and res.ess["latent"].shape == (64,)
    # whitened MALA's samples are lifted to the field x = mu + L gamma
    assert res.samples["latent"].shape == (4, 8, 64) and np.isfinite(res.samples["latent"]).all()
    assert 0.0 <= res.accept_rate <= 1.0 and res.num_samples == 8
    assert res.summary().startswith(f"lgc/{sampler}: 4 chains x 8 samples")


def test_torch_workload_cli_runs_stochvol_on_cpu(capsys):
    experiments.main(["--workload", "stochvol", "--sampler", "mala", "--device", "cpu", "--chains", "4",
                      "--samples", "6", "--burn-in", "2"])
    out = capsys.readouterr().out
    assert out.startswith("stochvol/mala: 4 chains x 6 samples")
    assert "hyper: ESS" in out and "latent: ESS" in out


@pytest.mark.parametrize("argv, needle", [
    (["--workload", "fhn", "--sampler", "gibbs"], "not available for workload"),
    (["--workload", "fhn", "--sampler", "iwls"], "not available for workload"),
    (["--workload", "fhn", "--sampler", "rmhmc_joint"], "not available for workload"),
    (["--workload", "lgc", "--sampler", "hmc"], "not available for workload"),
    (["--workload", "stochvol", "--sampler", "gibbs"], "not available for workload"),
    (["--workload", "sv"], "invalid choice"),
])
def test_torch_workload_cli_refusals(capsys, argv, needle):
    with pytest.raises(SystemExit) as exit_info:
        experiments.main([*argv, "--device", "cpu"])
    assert exit_info.value.code != 0
    err = capsys.readouterr().err
    assert needle in err


def test_torch_workload_library_refusals():
    with pytest.raises(KeyError, match="gibbs"):
        experiments.run_workload("fhn", "gibbs", device="cpu")
    assert len(experiments.build_workload("fhn", "rmhmc", device="cpu", fhn_obs=10, fhn_substeps=1)) == 5  # ported
    assert len(experiments.build_workload("lgc", "rmhmc_joint", device="cpu", lgc_n=4)) == 5  # ported: no refusal
    with pytest.raises(ValueError, match="run_experiment"):
        experiments.run_workload("blr", "rmhmc", device="cpu")
    with pytest.raises(KeyError):
        experiments.build_workload("stochvol", "gibbs", device="cpu")


def test_torch_load_data_reads_the_authors_files_or_generates(tmp_path, monkeypatch):
    """``load_data`` of StochVol and LGC: the authors' ``.mat`` where the data
    directory holds it, else the seeded ``generate_data`` (as the JAX package)."""
    from scipy.io import savemat

    from riemannhamiltonianmontecarlo_tpu.models import lgc as jlgc
    from riemannhamiltonianmontecarlo_tpu.models import stochvol as jsv
    from riemannhamiltonianmontecarlo_tpu_torch.models import datasets, lgc, stochvol

    monkeypatch.setattr(datasets, "_SEARCH_PATHS", (str(tmp_path),))
    np.testing.assert_array_equal(stochvol.load_data()[0], jsv.generate_data()[0])
    np.testing.assert_array_equal(lgc.load_data(n=4)[0], jlgc.generate_data(n=4)[0])
    savemat(tmp_path / stochvol.REFERENCE_MAT, {"y": np.arange(5.0)[:, None], "Truex": np.ones((5, 1))})
    savemat(tmp_path / lgc.REFERENCE_MAT, {"Y": np.arange(16.0).reshape(4, 4), "X": np.zeros((4, 4))})
    y, x = stochvol.load_data()
    np.testing.assert_array_equal(y, np.arange(5.0))
    np.testing.assert_array_equal(x, np.ones(5))
    np.testing.assert_array_equal(lgc.load_data(n=4)[0], np.arange(16.0))
