"""Entry points: one transition on one device, and a multi-rank dry run.

Counterpart of the repository's root ``__graft_entry__.py``:

* ``entry(device)`` returns ``(fn, args)``: one RMHMC transition (L 2, 2
  fixed-point rounds) of 64 chains on ``synthetic_logreg(0, 48, 6)``;
  ``fn(*args)`` gives the new positions and the accept probabilities;
* ``dryrun_multichip(n, device)`` starts n ranks (``parallel.launch``) and
  runs on them the chain-sharded RMHMC step on ``synthetic_logreg(0, 32,
  5)`` with 4n chains, the explicit all-reduce of the acceptance (checked to
  be 1 on a vector of ones) and, for even n, the phmc step on the LGC field
  ``generate_data(seed=0, n=16)`` (D = 256) over an (n/2, 2) mesh of
  ("chains", "latent") axes, whose operators hold D/2 rows a rank.

    python -m riemannhamiltonianmontecarlo_tpu_torch.entry --ranks 4 --device cpu
"""

from __future__ import annotations

import argparse

import torch

from riemannhamiltonianmontecarlo_tpu_torch import interop, models, parallel
from riemannhamiltonianmontecarlo_tpu_torch.parallel.launch import spawn
from riemannhamiltonianmontecarlo_tpu_torch.samplers import phmc, rmhmc


def _toy_model(n: int, d: int, device):
    ds = models.synthetic_logreg(seed=0, n=n, d=d)
    return interop.logreg_from_numpy(ds.X, ds.t, device=device)


def _device(device: str | torch.device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but torch.cuda.is_available() is False")
    return device


def entry(device: str | torch.device = "cuda"):
    """(fn, args): one RMHMC transition of 64 chains on the flagship model."""
    device = _device(device)
    model = _toy_model(48, 6, device)
    kernel = rmhmc.build(model, rmhmc.RMHMCConfig(num_leapfrog=2, num_fixed_point=2))
    with torch.inference_mode():
        state = kernel.init(torch.zeros((64, model.dim), device=device))

    def fn(generator: torch.Generator, state):
        with torch.inference_mode():
            new_state, info = kernel.step(generator, state)
        return new_state.position, info.accept_prob

    return fn, (torch.Generator(device=device).manual_seed(0), state)


def _dryrun_rank(device: str) -> None:
    """One rank of ``dryrun_multichip`` (run by ``parallel.launch``)."""
    n = torch.distributed.get_world_size()
    rank = torch.distributed.get_rank()
    device = torch.device(device)
    mesh = parallel.make_mesh()
    model = _toy_model(32, 5, device)
    kernel = parallel.chain_sliced(rmhmc.build(model, rmhmc.RMHMCConfig(num_leapfrog=2, num_fixed_point=2)), mesh)
    chains = 4 * n
    group = mesh.group(parallel.CHAIN_AXIS)
    with torch.inference_mode():
        state = kernel.init(parallel.shard_chains(mesh, torch.zeros((chains, model.dim), device=device)))
        new_state, info = kernel.step(torch.Generator(device=device).manual_seed(0), state)
        accept = float(parallel.cross_chain_mean(info.accept_prob, group))
        rate = float(parallel.cross_chain_mean(torch.ones((chains // n,), device=device), group))
    if new_state.position.shape != (chains // n, model.dim) or not bool(torch.isfinite(new_state.position).all()):
        raise RuntimeError(f"rank {rank}: local positions of shape {tuple(new_state.position.shape)}")
    if abs(rate - 1.0) > 1e-6:
        raise RuntimeError(f"rank {rank}: the all-reduced acceptance of ones is {rate}, not 1")
    if rank == 0:
        print(f"dryrun_multichip OK: {n} ranks, {chains} chains, accept={accept:.3f}", flush=True)

    if n % 2:
        return
    from riemannhamiltonianmontecarlo_tpu_torch.models import lgc

    mesh2 = parallel.make_mesh(n, (parallel.CHAIN_AXIS, "latent"), (n // 2, 2))
    y, _ = lgc.generate_data(seed=0, n=16)
    model2 = lgc.LGCModel(torch.tensor(y, dtype=torch.float32, device=device), n=16).with_sharding(mesh2)
    kernel2 = parallel.chain_sliced(phmc.build(model2, model2.metric_chol, model2.metric_inv,
                                               phmc.PHMCConfig(num_leapfrog=3)), mesh2)
    c2 = 2 * (n // 2)
    with torch.inference_mode():
        init2 = parallel.shard_chains(mesh2, model2.prior_mean().expand(c2, -1).clone())
        state2 = kernel2.init(init2)
        new2, info2 = kernel2.step(torch.Generator(device=device).manual_seed(1), state2)
        accept2 = float(parallel.cross_chain_mean(info2.accept_prob, mesh2.group(parallel.CHAIN_AXIS)))
    rows = tuple(model2.metric_inv.rows.shape)
    if rows != (model2.dim // 2, model2.dim):
        raise RuntimeError(f"rank {rank}: the latent operators hold {rows} rows, not ({model2.dim // 2}, {model2.dim})")
    if new2.position.shape != (2, model2.dim) or not bool(torch.isfinite(new2.position).all()):
        raise RuntimeError(f"rank {rank}: LGC positions of shape {tuple(new2.position.shape)}")
    if rank == 0:
        print(f"dryrun 2-axis OK: mesh {mesh2.shape}, LGC D={model2.dim}, operator rows a rank {rows}, "
              f"accept={accept2:.3f}", flush=True)


def dryrun_multichip(n: int, device: str = "cuda") -> str:
    """The sharded steps on ``n`` ranks (Gloo on the CPU, NCCL on cards);
    raises if a rank fails or the launch outlasts 120 s; returns rank 0's report."""
    _device(device)
    return spawn("riemannhamiltonianmontecarlo_tpu_torch.entry:_dryrun_rank", n, device=device, args=[device],
                 timeout=120.0)[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="One transition, then the multi-rank dry run.")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fn, fn_args = entry(args.device)
    position, accept = fn(*fn_args)
    print("entry OK", tuple(position.shape), f"accept={float(accept.mean()):.3f}")
    print(dryrun_multichip(args.ranks, args.device), end="")


if __name__ == "__main__":
    main()
