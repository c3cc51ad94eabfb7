"""The harness finds a configuration, a traffic mix, limits and a metric that are new files only."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import torch

from portbench import run, spec

ROOT = Path(__file__).resolve().parents[1]


def test_new_files_make_a_new_cell(tmp_path):
    root = tmp_path / "bench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    base = spec.load_json(ROOT / "configs" / "blr_australian.json")
    (root / "configs" / "blr_small.json").write_text(json.dumps(dict(base, num_data=200, num_features=5)))
    traffic = spec.load_json(ROOT / "traffic" / "blr_rmhmc_4096.json")
    (root / "traffic" / "blr_rmhmc_8.json").write_text(json.dumps(dict(
        traffic, chains=8, burn_in=5, segment_steps=3)))
    (root / "limits" / "blr_small.rmhmc_8.json").write_text(json.dumps({"position_err": 1e-4, "position_gap": 1e-2}))
    (root / "metrics" / "steps_seen.py").write_text("def read(facts):\n    return float(facts.steps)\n")
    bench = spec.load_json(run.CHECKOUT / "BENCHMARK.json")
    bench["workloads"].append({"name": "blr_small.rmhmc_8", "config": "blr_small", "traffic": "blr_rmhmc_8",
                               "chips": 1, "why": "a test"})
    bench["per_layer"] = [{"name": "steps_seen", "unit": "steps", "better": "higher", "source": "program_counter",
                           "layer": "runner and graphs", "moves": "samples_per_s", "workloads": ["blr_small.rmhmc_8"]}]
    cell = spec.resolve(bench, "blr_small.rmhmc_8", root=root)
    assert cell.config["num_data"] == 200 and cell.traffic["chains"] == 8
    out = run.run_cell(cell, 5, 0.5, True, torch.device("cpu"), time.perf_counter())
    assert out["correct"], out["checks"]
    assert list(out["metrics"]) == ["steps_seen"] and out["metrics"]["steps_seen"]["value"] > 0
    assert list(out)[-1] == "checks"
