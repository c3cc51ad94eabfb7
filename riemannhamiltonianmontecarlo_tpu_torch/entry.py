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
  ("chains", "latent") axes, whose operators hold D/2 rows a rank; then
  both through ``parallel.run(..., mesh=)``, 2 + 3 steps, by default and
  with ``capture=False``: bit for bit the same, with the same all-reduces
  counted on the device.  On cards the default replays each step's CUDA
  graph, the latent axis's all-reduces NCCL's inside it; over Gloo the
  LGC step runs eagerly.

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
    _dryrun_run("chains", rmhmc.build(model, rmhmc.RMHMCConfig(num_leapfrog=2, num_fixed_point=2)),
                torch.zeros((chains, model.dim), device=device), mesh, device)

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
    _dryrun_run("chains x latent", phmc.build(model2, model2.metric_chol, model2.metric_inv, phmc.PHMCConfig(
        num_leapfrog=3)), model2.prior_mean().expand(c2, -1).clone(), mesh2, device)


def _dryrun_run(label: str, kernel, init: torch.Tensor, mesh, device: torch.device) -> None:
    """``kernel`` through the runner with ``mesh``, by default (captured on a
    card) and eagerly: the same samples and device-counted all-reduces."""
    out = {}
    for capture in (None, False):
        captures = parallel.graphs.capture_count()
        parallel.collectives.reset_call_counts()
        res = parallel.run(kernel, torch.Generator(device=device).manual_seed(2), init, num_samples=3, burn_in=2,
                           mesh=mesh, capture=capture)
        out[capture] = (res.samples, parallel.collectives.call_counts()["all_reduce"],
                        parallel.graphs.capture_count() - captures)
    (graph, graph_reduces, made), (eager, eager_reduces, _) = out[None], out[False]
    if not torch.equal(graph, eager) or graph_reduces != eager_reduces:
        raise RuntimeError(f"rank {torch.distributed.get_rank()}: {label}: the default run differs from the eager one "
                           f"(all-reduces {graph_reduces} against {eager_reduces})")
    if device.type == "cuda" and kernel.capturable and made != 1:
        raise RuntimeError(f"rank {torch.distributed.get_rank()}: {label}: {made} captures on the card, expected one")
    if torch.distributed.get_rank() == 0:
        backends = {axis: parallel.collectives.backend(g) for axis, g in mesh.groups.items()}
        print(f"dryrun runner OK: {label} mesh {mesh.shape} over {backends}, {'captured' if made else 'eager'}, "
              f"bit for bit the eager run, {graph_reduces} all-reduces", flush=True)


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
