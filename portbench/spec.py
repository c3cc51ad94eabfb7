"""Finding a cell's pieces by name.

``BENCHMARK.json`` names a cell's configuration and traffic mix; everything
else is a file named after one of them:

* ``configs/<config>.json``: the configuration (its ``model`` names the family, its ``control`` the
  precision of the control, ``reference.precision``);
* ``traffic/<traffic>.json``: the traffic mix (sampler, constants, chains, burn-in, segment length);
* ``limits/<cell>.json``: the limit of each number the comparison reads;
* ``families/<model>.py``: builds the program's system for the family and its plain reference;
* ``flops/<model>_<sampler>.py``: the step's operations a chain, counted from the shapes;
* ``metrics/<metric>.py``: the reader of a metric, ``read(facts) -> float | None``.

So a later cell, configuration, traffic mix or metric is a new file, and no
file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import zlib
from pathlib import Path
from types import ModuleType
from typing import NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries of the metrics this cell reports with --trace 0
    per_layer: list  # and with --trace 1
    root: Path


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    """A metric with a ``workloads`` key is reported in the cells it lists, one without it in every cell."""
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` with its files read from ``root``."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; options: {sorted(by_name)}")
    w = by_name[name]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name)]
    return Cell(name, int(w["chips"]), load_json(root / "configs" / f"{w['config']}.json"),
                load_json(root / "traffic" / f"{w['traffic']}.json"), load_json(root / "limits" / f"{name}.json"),
                e2e, per_layer, root)


def module(root: Path, kind: str, name: str) -> ModuleType:
    """``<root>/<kind>/<name>.py``, imported under ``portbench.<kind>.<name>``."""
    path = root / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} named {name!r}: {path} is missing")
    mod_name = f"portbench.{kind}.{name}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(cell: Cell) -> ModuleType:
    return module(cell.root, "families", cell.config["model"])


def step_ops(cell: Cell) -> float:
    """The algorithm's operations a chain and step, from ``flops/<model>_<sampler>.py``."""
    return float(module(cell.root, "flops", f"{cell.config['model']}_{cell.traffic['sampler']}").step_ops(
        cell.config, cell.traffic))


def reader(cell: Cell, metric: str) -> ModuleType:
    return module(cell.root, "metrics", metric)


def seed_of(seed: int, label: str) -> int:
    """A 63-bit seed for one use (``label``) of the run's ``--seed``, any whole number up to 2**64 - 1."""
    state = np.random.SeedSequence([int(seed) % 2**64, zlib.crc32(label.encode())]).generate_state(1, dtype=np.uint64)
    return int(state[0]) & (2**63 - 1)
