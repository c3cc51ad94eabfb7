"""Bayesian logistic regression: the program's ``models.LogisticRegression`` under ``samplers.rmhmc`` or
``samplers.mmala``, the chains started at the mode plus seeded jitter."""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench import spec
from portbench.reference import blr
from portbench.yardstick import data

START_JITTER = 0.1  # the chains start at the mode plus this times a standard normal draw


def dataset(config: dict):
    """(X, t): the configuration's data, the same for every seed of a run."""
    return data.synthetic_logreg(config["data_seed"], config["num_data"], config["num_features"] + 1)


class System(NamedTuple):
    kernel: object
    state: object
    shapes: dict

    def noise(self, generator: torch.Generator, state) -> dict:
        return dict(self.kernel.draw_noise(generator, state.position)._asdict())

    @staticmethod
    def plain(state) -> dict:
        return {"w": state.position}


def build(config: dict, traffic: dict, seed: int, device) -> System:
    from riemannhamiltonianmontecarlo_tpu_torch import interop, samplers

    x, t = dataset(config)
    alpha = config["prior_variance"]
    model = interop.logreg_from_numpy(x, t, alpha=alpha, device=device)
    k = traffic["constants"]
    if traffic["sampler"] == "rmhmc":
        kernel = samplers.rmhmc.build(model, samplers.rmhmc.RMHMCConfig(
            step_size=k["step_size"], num_leapfrog=k["num_leapfrog"], num_fixed_point=k["num_fixed_point"]))
    elif traffic["sampler"] == "mmala":
        kernel = samplers.mmala.build(model, samplers.mmala.MMALAConfig(step_size=k["step_size"]))
    else:
        raise ValueError(f"no logistic-regression driver for sampler {traffic['sampler']!r}")
    chains, d = traffic["chains"], x.shape[1]
    gen = torch.Generator(device=device).manual_seed(spec.seed_of(seed, "start"))
    start = torch.as_tensor(data.map_estimate(x, t, alpha), dtype=torch.float32, device=device)
    start = start + START_JITTER * torch.randn((chains, d), generator=gen, device=device)
    with torch.inference_mode():
        state = kernel.init(start)
    shapes = {"C": chains, "N": x.shape[0], "D": d, "L": k.get("num_leapfrog", 1), "R": k.get("num_fixed_point", 0)}
    return System(kernel, state, shapes)


class Reference(NamedTuple):
    model: blr.Model
    sampler: str
    constants: dict

    def sweep(self, plain_in: dict, noise: dict, follow: dict | None = None) -> list:
        p = self.model.p
        w = p.t(plain_in["w"]).to(self.model.x.device)
        return [("position", "w", blr.transition(self.sampler, self.model, w, noise, self.constants))]


def reference(config: dict, traffic: dict, precision, device) -> Reference:
    x, t = dataset(config)
    return Reference(blr.Model(x, t, config["prior_variance"], precision, device), traffic["sampler"],
                     traffic["constants"])
