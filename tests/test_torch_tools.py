"""Port: the results tools (``riemannhamiltonianmontecarlo_tpu_torch/tools``).

* the helpers give the JAX tools' strings for the same numbers: ``fmt``,
  ``splice``, ``row``, ``aggregate_rows``, the ``HEADER`` strings and the
  ``PAPER`` / ``CHAINS`` / ``TABLE_NO`` / ``SAMPLERS`` constants (the root
  ``tools/*.py`` imported by path);
* ``make_results``' rmhmc row on a synthetic australian-shaped CSV at 64
  chains and 50 + 50 on the CPU, its acceptance within 0.05 of the JAX
  package's ``run_experiment`` at the same constants and depth;
* ``make_results_all``'s StochVol path at T = 20, with the kept samples on
  the device and streamed to the host: the same table;
* a section spliced into ``--out``, ``RESULTS.md`` byte-identical after
  the module; ``--device cuda`` without a card an error in every tool.
"""

import hashlib
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from riemannhamiltonianmontecarlo_tpu_torch.models import datasets, synthetic_logreg
from riemannhamiltonianmontecarlo_tpu_torch.tools import (
    common,
    ess_engine_bench,
    make_results,
    make_results_adaptive,
    make_results_all,
    probe_scaling,
    scaling_table,
)

REPO = Path(__file__).resolve().parents[1]
RESULTS = REPO / "RESULTS.md"
ACCEPT_TOL = 0.05


def jax_tool(name: str):
    """The JAX package's ``tools/<name>.py``, imported by path."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    finally:
        sys.path.remove(str(REPO / "tools"))


@pytest.fixture(scope="module", autouse=True)
def results_untouched():
    before = hashlib.sha256(RESULTS.read_bytes()).hexdigest()
    yield
    assert hashlib.sha256(RESULTS.read_bytes()).hexdigest() == before, "a results tool wrote RESULTS.md"


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """An australian-shaped CSV (690 x 14 features, then the label) where
    both packages' loaders look."""
    import riemannhamiltonianmontecarlo_tpu.models.datasets as jax_datasets

    d = tmp_path_factory.mktemp("data")
    ds = synthetic_logreg(seed=0, n=690, d=15)
    np.savetxt(d / "australian.csv", np.column_stack([ds.X[:, 1:], ds.t]), delimiter=",")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(datasets, "_SEARCH_PATHS", (str(d),))
        mp.setattr(jax_datasets, "_SEARCH_PATHS", (str(d),))
        yield d


NUMBERS = (0.0, 1e-7, 0.01234, 3.14159, 999.4, 1000.0, 12345.678, -2.5e6)


def test_torch_tools_helpers_give_the_jax_tools_strings():
    jmr, jall, jada = jax_tool("make_results"), jax_tool("make_results_all"), jax_tool("make_results_adaptive")
    for x in NUMBERS:
        assert make_results.fmt(x) == jmr.fmt(x) == make_results_all.fmt(x) == jall.fmt(x)
    for text in ("# RESULTS\n", "# R\n\n<!-- section:a -->\nold\n<!-- end:a -->\ntail\n",
                 "x\n<!-- section:blr-german -->\nold\n<!-- end:blr-german -->\n"):
        for name in ("a", "blr-german", "new"):
            assert make_results.splice(text, name, "S\nT") == jmr.splice(text, name, "S\nT")
    assert (make_results.HEADER, make_results.PAPER, make_results.CHAINS, make_results.TABLE_NO) == \
        (jmr.HEADER, jmr.PAPER, jmr.CHAINS, jmr.TABLE_NO)
    assert make_results_all.HEADER == jall.HEADER and make_results_all.N_SEEDS == jall.N_SEEDS
    assert (make_results_adaptive.HEADER, make_results_adaptive.SAMPLERS) == (jada.HEADER, jada.SAMPLERS)
    rng = np.random.default_rng(0)
    for seeds in (1, 3):
        per_seed = [(tuple(rng.uniform(10, 5000, 3)), float(rng.uniform(1, 1.1)), float(rng.uniform()),
                     float(rng.uniform(1, 100)), int(rng.integers(0, 3))) for _ in range(seeds)]
        got, want = make_results_all.aggregate_rows(per_seed), jall.aggregate_rows(per_seed)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for paper in (2.37, None, (("transient", 10605), ("stationary", 7836))):
            assert make_results_all.row("rmhmc", 64, 20000, got, paper) == jall.row("rmhmc", 64, 20000, want, paper)
    nan_rhat = dict(got, rhat=float("nan"))
    assert make_results_all.row("x", 2, 5, nan_rhat, 1.0) == jall.row("x", 2, 5, nan_rhat, 1.0)


def test_torch_make_results_rmhmc_row_matches_jax_acceptance(data_dir):
    from riemannhamiltonianmontecarlo_tpu.experiments import run_experiment as jax_run_experiment

    depth = dict(samples=50, burn_in=50)
    section = make_results.run_dataset("australian", device="cpu", chains=64, samplers=("rmhmc",), **depth)
    lines = section.splitlines()
    assert lines[0] == "## BLR australian (paper Table 3), " + common.device_line(torch.device("cpu"))
    assert f"Data: australian.csv from {data_dir}." in section
    rows = [line for line in lines if line.startswith("| rmhmc ")]
    assert len(rows) == 1 and lines[lines.index(make_results.HEADER.splitlines()[1]) + 1] == rows[0]
    cells = [c.strip() for c in rows[0].strip("|").split("|")]
    assert cells[:3] == ["rmhmc", "64", "50"] and cells[4] == "0" and cells[9] == "0.016"
    assert all(np.isfinite(float(c)) for c in (cells[3], cells[5], cells[7], cells[8]))
    jax_res = jax_run_experiment("rmhmc", "australian", num_chains=64, num_samples=50, burn_in=50, ess_mode="device")
    assert float(cells[3]) == pytest.approx(jax_res.accept_rate, abs=ACCEPT_TOL)


def test_torch_make_results_all_stochvol_section_keeps_samples_on_device_or_host():
    kw = dict(device="cpu", chains=8, samples=20, burn_in=10, samplers=("rmhmc",), obs=20)
    (got, expected), section = make_results_all.run_stochvol(1, **kw)
    (got_host, _), section_host = make_results_all.run_stochvol(1, keep="host", **kw)
    assert (got, got_host, expected) == (2, 2, 8)
    assert "## Stochastic volatility -- T=20 (synthetic T=20 draw;" in section
    rows = [line for line in section.splitlines() if line.startswith("| rmhmc ")]
    rows_host = [line for line in section_host.splitlines() if line.startswith("| rmhmc ")]
    assert len(rows) == 2
    for a, b in zip(rows, rows_host):  # the same samples: all but the timed columns agree
        ca, cb = a.split("|"), b.split("|")
        assert ca[1:8] == cb[1:8] and ca[10] == cb[10]
        assert ca[4].strip() != "0.000" and "nan" not in a


def test_torch_tools_splice_into_out_and_never_results_md(tmp_path):
    out = tmp_path / "section.md"
    common.emit("blr-australian", "## first", out)
    common.emit("blr-australian", "## second", out)
    common.emit("scaling", "## s", out)
    text = out.read_text()
    assert text.count("<!-- section:blr-australian -->") == 1 and "## second" in text and "## first" not in text
    assert text.index("<!-- section:blr-australian -->") < text.index("<!-- section:scaling -->")
    with pytest.raises(ValueError, match="JAX package's record"):
        common.emit("blr-australian", "## x", RESULTS)


@pytest.mark.parametrize("tool", [make_results, make_results_adaptive, make_results_all, ess_engine_bench,
                                  probe_scaling, scaling_table], ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_torch_tools_cuda_without_a_card_is_an_error(tool, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = ["stochvol"] if tool is probe_scaling else []
    with pytest.raises(SystemExit) as e:
        tool.main([*argv, "--device", "cuda"])
    assert e.value.code == 2 and "torch.cuda.is_available() is False" in capsys.readouterr().err
