"""Stochastic volatility: the program's ``models.StochVolModel`` under ``samplers.stochvol``'s two-block
sweep ("rmhmc" or "mmala" in both blocks), every chain started at the generating hyperparameters and the
simulated log-volatilities."""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference import stochvol as ref_sv
from portbench.yardstick import data


def dataset(config: dict):
    """(y, x): the configuration's observations and simulated log-volatilities, the same for every seed."""
    g = config["generating"]
    return data.stochvol_data(config["data_seed"], config["num_obs"], g["beta"], g["sigma"], g["phi"])


class System(NamedTuple):
    kernel: object
    state: object
    shapes: dict

    def noise(self, generator: torch.Generator, state) -> dict:
        n = self.kernel.draw_noise(generator, state)
        out = {k: v for k, v in n._asdict().items() if k != "hyper"}
        out["hyper"] = dict(n.hyper._asdict())
        return out

    @staticmethod
    def plain(state) -> dict:
        return {"x": state.x, "theta": state.theta}


def build(config: dict, traffic: dict, seed: int, device) -> System:
    from riemannhamiltonianmontecarlo_tpu_torch import interop, samplers

    y, x_true = dataset(config)
    model = interop.stochvol_from_numpy(y, device=device)
    k = traffic["constants"]
    kernel = samplers.stochvol.build(model, samplers.stochvol.StochVolConfig(
        method=traffic["sampler"], latent_num_leapfrog=k.get("latent_num_leapfrog", 50),
        latent_step_size=k["latent_step_size"], hyper_num_leapfrog=k.get("hyper_num_leapfrog", 6),
        hyper_step_size=k["hyper_step_size"], hyper_num_fixed_point=k.get("hyper_num_fixed_point", 5),
        hyper_jitter=k["hyper_jitter"]))
    chains = traffic["chains"]
    g = config["generating"]
    position = torch.tensor([g["beta"], g["sigma"], g["phi"]], dtype=torch.float32, device=device).expand(chains, 3)
    with torch.inference_mode():
        theta = model.unconstrain(position[:, 0], position[:, 1], position[:, 2])
        x = torch.as_tensor(x_true, dtype=torch.float32, device=device).expand(chains, -1).clone()
        state = samplers.stochvol.StochVolState(position.clone(), theta, x)
    shapes = {"C": chains, "T": len(y), "D": 3, "L": k.get("hyper_num_leapfrog", 1),
              "R": k.get("hyper_num_fixed_point", 0), "latent_L": k.get("latent_num_leapfrog", 0)}
    return System(kernel, state, shapes)


class Reference(NamedTuple):
    model: ref_sv.Model
    sampler: str
    constants: dict

    def sweep(self, plain_in: dict, noise: dict, follow: dict | None = None) -> list:
        p = self.model.p
        device = self.model.y2.device
        x, theta = p.t(plain_in["x"]).to(device), p.t(plain_in["theta"]).to(device)
        latent = self.model.latent(self.sampler, x, theta, noise, self.constants)
        x_next = p.t(follow["x"]).to(device) if follow is not None else latent.moved(x)
        hyper = self.model.hyper(self.sampler, theta, x_next, noise["hyper"], self.constants)
        return [("latent", "x", latent), ("hyper", "theta", hyper)]


def reference(config: dict, traffic: dict, precision, device) -> Reference:
    y, _ = dataset(config)
    return Reference(ref_sv.Model(y, precision, device), traffic["sampler"], traffic["constants"])
