"""Start a function on n ranks, each a plain ``python`` subprocess.

``spawn("package.module:function", n, device=...)`` starts n processes of
``python -m riemannhamiltonianmontecarlo_tpu_torch.parallel.launch``; each
joins one process group over a free local TCP port
(``parallel.mesh.initialize_distributed``), calls the function with the
JSON arguments given, and tears the group down.  A rank that fails, or a
launch that outlasts ``timeout`` seconds, fails the whole launch: every
process is stopped and the ranks' output is in the error.  The process
group's own timeout is the same, so a collective that hangs raises in its
rank instead of waiting.

Used by ``entry.dryrun_multichip``, the port's multi-rank tests and
``chip_smoke.py``.  ``torchrun --nproc-per-node n`` is the other way to
start ranks; the port reads its environment the same way.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(fn: str, world_size: int, *, device: str = "cuda", backend: str | None = None, args: list | None = None,
          timeout: float = 120.0, pythonpath: list[str] | None = None, env: dict[str, str] | None = None) -> list[str]:
    """Run ``fn`` ("module:function") on ``world_size`` ranks; return each rank's output."""
    port = free_port()
    paths = [str(REPO), *(pythonpath or [])]
    child_env = {**os.environ, **(env or {}),
                 "PYTHONPATH": os.pathsep.join(paths + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    if device == "cpu":  # ranks on one host's CPU share its cores
        child_env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // world_size)))
    cmd = [sys.executable, "-m", "riemannhamiltonianmontecarlo_tpu_torch.parallel.launch", fn,
           "--world-size", str(world_size), "--init-method", f"tcp://localhost:{port}", "--device", device,
           "--timeout", str(timeout), "--args", json.dumps(args or [])]
    if backend:
        cmd += ["--backend", backend]
    with tempfile.TemporaryDirectory() as logs:
        files = [open(Path(logs) / f"rank{r}.log", "w+") for r in range(world_size)]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], stdout=f, stderr=subprocess.STDOUT, text=True,
                                  env=child_env) for r, f in enumerate(files)]
        deadline, timed_out = time.monotonic() + timeout, False
        try:
            # A rank that fails stops the others: they would wait for it in a collective.
            while any(p.poll() is None for p in procs):
                timed_out = time.monotonic() > deadline
                if timed_out or any(p.returncode not in (None, 0) for p in procs):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            outs = []
            for f in files:
                f.seek(0)
                outs.append(f.read())
                f.close()
    if timed_out:
        raise TimeoutError(f"{fn} on {world_size} ranks outlasted {timeout} s:\n"
                           + "\n".join(f"--- rank {r}\n{o[-2000:]}" for r, o in enumerate(outs)))
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"{fn}: ranks {failed} of {world_size} failed (exit codes "
                           f"{[procs[r].returncode for r in failed]}):\n"
                           + "\n".join(f"--- rank {r}\n{outs[r][-3000:]}" for r in failed))
    return outs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("fn", help="module:function")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--args", default="[]")
    a = ap.parse_args(argv)

    import torch.distributed as dist

    from riemannhamiltonianmontecarlo_tpu_torch.parallel.mesh import initialize_distributed

    module, name = a.fn.split(":")
    fn = getattr(importlib.import_module(module), name)
    initialize_distributed(device=a.device, backend=a.backend, init_method=a.init_method, world_size=a.world_size,
                           rank=a.rank, timeout=timedelta(seconds=a.timeout))
    try:
        fn(*json.loads(a.args))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
