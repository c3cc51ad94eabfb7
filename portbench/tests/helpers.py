"""Cells of BENCHMARK.json cut to sizes a CPU test run holds."""

from __future__ import annotations

from portbench import run, spec

CELLS = ("blr_australian.rmhmc_4096", "stochvol_t2000.rmhmc_1024", "blr_australian.mmala_4096",
         "stochvol_t2000.mmala_1024")


def small_cell(name: str, chains: int = 16, **config):
    """The cell with few chains, a short burn-in and, for StochVol, T = 200; BLR keeps australian's shape."""
    cell = spec.resolve(spec.load_json(run.CHECKOUT / "BENCHMARK.json"), name)
    cfg = dict(cell.config)
    if cfg["model"] == "stochvol":
        cfg["num_obs"] = 200
    cfg.update(config)
    traffic = dict(cell.traffic, chains=chains, burn_in=10, segment_steps=4)
    return cell._replace(config=cfg, traffic=traffic)
