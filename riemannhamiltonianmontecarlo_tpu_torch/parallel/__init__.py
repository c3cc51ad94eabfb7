"""Execution layer: the chain runner (plain and checkpointed) and its CUDA
graphs, step-size adaptation, the mesh and collectives of ``torch.distributed``, monitoring."""

from riemannhamiltonianmontecarlo_tpu_torch.parallel.mesh import (
    CHAIN_AXIS,
    Mesh,
    chain_slice,
    chain_sliced,
    initialize_distributed,
    make_mesh,
    shard_chains,
)
from riemannhamiltonianmontecarlo_tpu_torch.parallel import collectives, graphs
from riemannhamiltonianmontecarlo_tpu_torch.parallel.collectives import cross_chain_mean, cross_chain_sum
from riemannhamiltonianmontecarlo_tpu_torch.parallel.adaptation import (
    AdaptationConfig,
    adaptive,
    frozen_step_size,
    run_adaptive,
)
from riemannhamiltonianmontecarlo_tpu_torch.parallel.monitor import monitor, profile_trace
from riemannhamiltonianmontecarlo_tpu_torch.parallel.runner import RunResult, run, run_checkpointed, segment_generator

__all__ = ["AdaptationConfig", "adaptive", "frozen_step_size", "run_adaptive", "RunResult", "run", "run_checkpointed",
           "segment_generator", "CHAIN_AXIS", "Mesh", "make_mesh", "chain_slice", "chain_sliced", "shard_chains",
           "initialize_distributed", "cross_chain_mean", "cross_chain_sum", "monitor", "profile_trace"]
