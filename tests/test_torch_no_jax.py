"""The port and chip_smoke.py import no jax; chip_smoke.py refuses a machine without CUDA.

Run in subprocesses: this test process already imports jax (conftest.py).
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

TINY_TRANSITION = """
import sys
import torch
import riemannhamiltonianmontecarlo_tpu_torch as rt
import chip_smoke  # noqa: F401
import riemannhamiltonianmontecarlo_tpu_torch.step_profile  # noqa: F401
import riemannhamiltonianmontecarlo_tpu_torch.kernel_ab  # noqa: F401
import riemannhamiltonianmontecarlo_tpu_torch.tools.run_lgc_joint  # noqa: F401
from riemannhamiltonianmontecarlo_tpu_torch.tools import (  # noqa: F401
    common, ess_engine_bench, make_results, make_results_adaptive, make_results_all, probe_scaling, scaling_table)
import riemannhamiltonianmontecarlo_tpu_torch.models.fhn  # noqa: F401
import riemannhamiltonianmontecarlo_tpu_torch.ops.fhn_sens  # noqa: F401
import riemannhamiltonianmontecarlo_tpu_torch.entry  # noqa: F401
import riemannhamiltonianmontecarlo_tpu_torch.parallel.launch  # noqa: F401
import riemannhamiltonianmontecarlo_tpu_torch.diagnostics.plots  # noqa: F401
assert rt.samplers.lgc_joint and rt.models.LGCJointModel and rt.utils.checkpoint and rt.parallel.run_checkpointed
assert rt.models.FHNModel and rt.models.fhn and rt.ops.fhn_sens and rt.interop.fhn_from_numpy
assert rt.parallel.make_mesh and rt.parallel.chain_sliced and rt.parallel.cross_chain_mean and rt.parallel.monitor
assert rt.parallel.profile_trace and rt.parallel.collectives.RowShards and rt.diagnostics.ess_geyer_native
assert rt.models.LogisticRegression.with_sharding and rt.models.LGCModel.with_sharding
assert "matplotlib" not in sys.modules, "the plots module imports matplotlib only when it draws"
ds = rt.models.synthetic_logreg(0, 50, 5)
model = rt.interop.logreg_from_numpy(ds.X, ds.t, device="cpu")
kern = rt.samplers.rmhmc.build(model)
gen = torch.Generator().manual_seed(0)
state, info = kern.step(gen, kern.init(rt.utils.default_init(model, gen, 4)))
assert torch.isfinite(state.position).all() and info.accept_prob.shape == (4,)
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert not loaded, loaded
jax_package = sorted(m for m in sys.modules if m.split(".")[0] == "riemannhamiltonianmontecarlo_tpu")
assert not jax_package, jax_package
print("no-jax-ok")
"""


def _run(args, cwd, **kw):
    env = {**os.environ, "PYTHONPATH": str(REPO) if cwd == REPO else ""}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300, **kw)


def test_torch_port_imports_no_jax():
    proc = _run(["-c", TINY_TRANSITION], REPO)
    assert proc.returncode == 0, proc.stderr
    assert "no-jax-ok" in proc.stdout


def test_torch_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card it exits non-zero and prints no result line."""
    proc = _run([str(REPO / "chip_smoke.py")], REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    # alone in a directory (no port beside it) it fails as well
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = _run([str(tmp_path / "chip_smoke.py")], tmp_path)
    assert alone.returncode != 0
    assert '"ok"' not in alone.stdout
