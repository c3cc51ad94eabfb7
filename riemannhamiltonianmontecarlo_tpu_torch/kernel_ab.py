"""Time the hand-written kernels of two checkouts in turns on one CUDA card.

    python -m riemannhamiltonianmontecarlo_tpu_torch.kernel_ab --parent DIR [--kernels linalg,fhn,gibbs,geometry,bidiag,pcr,fixed_point] [--out FILE]

``DIR`` holds another checkout of the repository (for example an earlier
commit unpacked with ``git archive`` under the git-ignored ``build/``); this
checkout is the change.  The two are measured in the order parent, change,
change, parent, each turn in a process of its own that imports the port
from that checkout, builds its kernels there and times them with this
checkout's ``chip_smoke.py`` helpers.  ``--kernels linalg`` (the default)
times K1 / K2 at ``chip_smoke.TIMED_SHAPES``:

* ``ms``: median CUDA-event time of one wrapper call (50 calls);
* ``burst_ms``: 200 wrapper calls back to back, over the count;
* ``kernel_only_ms``: 200 launches back to back on allocated operands;
* ``device_us``: the kernel's own duration by name, torch.profiler, 50 launches;
* ``wrapper_device_us`` / ``wrapper_device_kernels``: every device event of
  one wrapper call (the kernel and whatever copies the wrapper makes).

A checkout whose wrappers take chains-last (D, D, C) operands (no
``hopper_linalg.launch_geometry``) gets its launches on such operands.

``--kernels fhn`` times the FitzHugh-Nagumo sensitivity kernel
(``fhn_sens.fhn_sensitivities_cuda``) at orders 0-2 on ``FHN_CHAINS``
chains at chip_smoke's 200 observations x 5 substeps, theta seeded around
the truth (the same in every turn): ``device_us`` (torch.profiler, 20
launches), ``burst_ms``, ``ms``, the roofline ``bound_us`` and this
checkout's ``critical_path_us`` (``fhn_sens.critical_path_us`` at the
card's maximum SM clock), with each share of ``device_us``; and, per turn,
the kernel's RK4 step loop as each checkout's build compiled it
(``fhn_rk4_loop``, from ``cuobjdump -sass``): RK4 steps per loop pass, SASS
instructions per step and the branches inside the loop.  A checkout that
takes any number of observations (no ``fhn_sens.MAX_OBS``) is also timed at
``FHN_LONG`` (num_obs, substeps), 256 chains, every order (CUDA events over 5
launches: milliseconds each).
``--kernels gibbs`` times the Gibbs sweep kernel G1
(``samplers.gibbs.gibbs_sweep_cuda``) on ``chip_smoke.gibbs_inputs`` at
N = 690 and D in ``GIBBS_DIMS``, the inputs of 1024 chains cut or repeated
along the chains to each of ``GIBBS_CHAINS``: ``device_us``
(torch.profiler, 10 launches), and ``burst_ms`` (CUDA events over 5
launches) at the wrapper's own layout; in a checkout whose G1 spreads a
chain over lanes, at every lane count (``lanes``).  A time that stays flat
while each warp has a scheduler of its own says a chain's sequence of
steps is what bounds the kernel.  A checkout whose G1 takes any D (a
``sweep_layout``) is also timed at chip_smoke's ``SWEEP_WIDE_SHAPES`` and,
B in registers on 32 lanes against the wide layout, at D = 32 x
``SWEEP_ENT_MAX`` on (C, N) = ``SWEEP_BOTH_CN``, each wide shape on the
wrapper's layout and on each of its checkout's wide forms (a warp a chain
with B in shared memory or in the output buffer; or a block of 1, 2, 4 or
8 warps a chain with B in registers, and B in shared memory and in the
output buffer), and at chip_smoke's ``SWEEP_OPTIN_SHAPE`` where the wide
layout is a block of warps.  Then the GIG draw of a step as each checkout runs it
(``ops.sample_gig_half`` at (1024, 690): 64 rounds and 192 draws, or one
launch), its device time and CUDA-event times; and per turn G1's step loop
in each build's SASS (``gibbs_sweep_loop``, the register layout's and the
wide layout's kernels at the entries a lane of ``GIBBS_LOOP_ENTRIES``):
instructions once through, branches, shuffles, MUFU instructions and loads.
``--kernels geometry`` times RMHMC's geometry as each checkout computes it
on a (C, D, D) CUDA batch at ``chip_smoke.TIMED_SHAPES``: ``ops.chol_inv_logdet``
(K3, one launch) where the checkout has it, else ``ops.cholesky`` (K1), the
unrolled ``ops.inv_psd_from_chol`` and ``0.5 * ops.logdet_from_chol``; and
``--kernels bidiag`` StochVol's bidiagonal factor ``ops.tridiag.cholesky`` as
each checkout runs it at ``BIDIAG_RUNS`` (T1 on the pivots reading the
expanded off-diagonal through its strides, the earlier T1 walking ld_t after a
copy of it, or the loop of three launches a position), on the latent
metric as the model makes it and on HMC's identity mass; ``--kernels pcr``
StochVol's PCR solve ``ops.tridiag.solve`` as each checkout runs it at
``PCR_RUNS`` (T2, or the plain version's 335 launches) on the
same two metrics and a seeded b, and per turn T2's round loop in each
build's SASS (``pcr_round_loop``: instructions a position once through,
the IEEE divisions' checks and slow-path calls, branches, shared-memory
loads and stores, barriers).  With K3, ``geometry`` also gives per turn
K3's body in each build's SASS at D 15 and 25 (``k3_body``: shuffles,
shared loads by width, shared stores, barriers, division checks and
slow-path calls, copies, each also a chain) and its phase split
(``k3_phases``: a lab build of the checkout's ``hopper_linalg.cu`` with
-DRHMC_K3_STAMPS, made under ``build/k3_lab/``).  Each is captured
as one CUDA graph, as the captured step runs it: ``device_us`` (every device
event of a replay, torch.profiler, 20 replays), ``device_events_per_call``,
``replay_ms`` (median CUDA-event time of one replay) and ``burst_ms`` (20
replays back to back), beside the function's ``bound_us``.
``--kernels fixed_point`` times BLR RMHMC's two fixed points as each
checkout computes them at ``FIXED_POINT_RUNS`` on ``chip_smoke.fixed_point_inputs``:
the model's ``position_fixed_point`` / ``momentum_fixed_point`` (K4 / K5)
where the checkout has them, else the sampler's loops (``model.metric`` and
``ops.solve_psd``, K2 a round; ``dg_bilinear``), 4 rounds and the one-round
half-step, each captured as one CUDA graph as above, beside
``chip_smoke.fixed_point_bound_us``; in every turn also the loops themselves
(``route`` "loops": the checkout's plain versions, K2 a position round), so
that each width's kernel is held against the route it replaced in the same
process; per turn K4's and K5's round loops in each build's SASS at D 7, 15
and 25 (``fixed_point_loops``: the loop with the most FFMAs of its own, nested
loops' instructions left out, its instructions, FFMAs and their share,
shared loads by width, shuffles and branches, each also a row, and the
kernel's registers and spill from ``ptxas.log``); and, where the source has
the hooks, K4's phase split at ``K4_PHASE_RUNS`` (``k4_phases``: a lab build
of the checkout's ``logreg_fixed_point.cu`` with -DRHMC_K4_STAMPS, made under
``build/k4_lab/``: thread 0 of each block adds the clock64() cycles of
waiting for X, making the pair table, the logits and weights, the products, the chunks'
barriers, the sets' sums and the factor with its solves and update).
Prints one JSON line per turn, kernel and shape, with the card's name and
power limit.  Needs a CUDA device and nvcc; there is no CPU path.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
TURNS = ("parent", "change", "change", "parent")
KERNELS = ("linalg", "fhn", "gibbs", "geometry", "bidiag", "pcr", "fixed_point")
# (C, N, D): the main path (australian), german, 2 x C, the other BLR datasets' shapes (ripley, pima, heart: the
# route by width below 15) and a run-time width on the capacity 16 (D 9-13 and 16 take it)
FIXED_POINT_RUNS = ((4096, 690, 15), (4096, 1000, 25), (8192, 690, 15), (4096, 250, 7), (4096, 532, 8),
                    (4096, 270, 14), (4096, 690, 10))
K4_PHASE_RUNS = ((4096, 690, 15), (4096, 1000, 25), (4096, 250, 7))
FIXED_POINT_ROUND_COUNTS = (1, 2, 4, 8)
FIXED_POINT_SASS_WIDTHS = (7, 15, 25)
BIDIAG_RUNS = ((1024, 2000, "metric"), (1024, 2000, "identity"), (4096, 2000, "metric"))  # (B, T, G)
PCR_RUNS = ((1024, 2000, "metric"), (1024, 2000, "identity"), (4096, 2000, "metric"), (4096, 2000, "identity"))
FHN_CHAINS = (256, 4224)  # the FHN samplers' chain count; one warp on each SM at one lane per chain
FHN_LONG = ((8192, 5), (50000, 1))  # (num_obs, substeps) past the first form's 6,144 observations
GIBBS_DATA = 690  # australian's N
GIBBS_DIMS = (15, 40)  # australian's D; a width no BLR dataset has
GIBBS_CHAINS = (32, 1024, 4224, 8448)  # a warp; phase 6's; a warp on each of 528 schedulers; two
GIBBS_WIDE_WARPS = (1, 2, 4, 8)  # the wide layout's warps a chain with B in registers, timed each


def _measure(root: Path, kernels: list[str]) -> list[dict]:
    """Runs in the child: import the port from ``root`` and time its kernels."""
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke  # dataclasses looks a class's module up there
    spec.loader.exec_module(smoke)  # imports the port: from root, first on sys.path
    for module in (smoke.hl, smoke.rt.ops.fhn_sens):
        if Path(module.__file__).resolve().parents[2] != root.resolve():
            raise RuntimeError(f"imported the port from {module.__file__}, not from {root}")
    rows = []
    # A checkout whose wrappers count launches on the device (ops.launches) times them without that count.
    counters = getattr(smoke.rt.ops, "launches", None)
    with counters.paused() if counters else contextlib.nullcontext():
        if "linalg" in kernels:
            rows += _measure_linalg(smoke)
        if "fhn" in kernels:
            rows += _measure_fhn(smoke)
        if "gibbs" in kernels:
            rows += _measure_gibbs(smoke)
        if "geometry" in kernels:
            rows += _measure_geometry(smoke)
        if "bidiag" in kernels:
            rows += _measure_bidiag(smoke)
        if "pcr" in kernels:
            rows += _measure_pcr(smoke)
        if "fixed_point" in kernels:
            rows += _measure_fixed_point(smoke)
    return rows


def _captured(smoke, fn) -> dict:
    """``fn`` captured as one CUDA graph: its replay's device time (every device event), events, and times."""
    import torch

    fn()  # warm: allocations and builds happen outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    dev = smoke.device_us(graph.replay, launches=20)
    return {"device_us": dev["us"], "device_us_source": dev["source"], "device_events_per_call": dev["events_per_call"],
            "replay_ms": smoke.median_ms(graph.replay, reps=20), "burst_ms": smoke.burst_ms(graph.replay, launches=20)}


def _measure_geometry(smoke) -> list[dict]:
    import torch

    ops, card, rows = smoke.rt.ops, smoke.smi_line(), []
    if hasattr(ops, "chol_inv_logdet"):
        route, geometry = "K3", ops.chol_inv_logdet
    else:
        route = "K1 + unrolled inverse + log-det"

        def geometry(g):
            l = ops.cholesky(g)
            return l, ops.inv_psd_from_chol(l), 0.5 * ops.logdet_from_chol(l)
    with torch.inference_mode():
        for c, d in smoke.TIMED_SHAPES:
            g, _ = smoke.spd_batch(c, d, seed=d)
            bound, bound_by = smoke.bound_us("chol_inv_logdet", c, d)
            row = _captured(smoke, lambda: geometry(g))
            rows.append({"kernel": "geometry", "C": c, "D": d, "route": route, **row, "bound_us": bound,
                         "bound_by": bound_by, "share_of_bound": bound / row["device_us"], "card": card})
    if route == "K3":
        rows.append({"kernel": "k3_body", "card": card, **_k3_body(smoke)})
        rows += [{"kernel": "k3_phases", "C": c, "D": d, "card": card, **_k3_phases(smoke, c, d)}
                 for c, d in K3_PHASE_SHAPES]
    return rows


K3_SASS_WIDTHS = (15, 25)  # australian's and german's D
K3_PHASE_SHAPES = ((4096, 15), (4096, 25), (8192, 15))
# SASS opcode groups counted in K3's body: (key, opcodes, width suffix or None for any).
_K3_OPS = (("shfl", ("SHFL",)), ("sts", ("STS",)), ("bar", ("BAR",)), ("warpsync", ("WARPSYNC",)),
           ("fchk", ("FCHK",)), ("calls", ("CALL",)), ("ldgsts", ("LDGSTS",)), ("bulk", ("UBLKCP", "UTMALDG", "UTMASTG")),
           ("syncs", ("SYNCS",)), ("ldg", ("LDG",)), ("stg", ("STG",)), ("mufu", ("MUFU",)), ("ffma", ("FFMA",)))


def _k3_body(smoke) -> dict:
    """K3 as each build compiled it, at the compile-time widths of K3_SASS_WIDTHS: static SASS instructions of
    the whole function and by opcode (shuffles, shared loads by width, shared stores, barriers, the IEEE
    divisions' checks and slow-path calls, cp.async and bulk copies, mbarrier operations), each also over the
    chains a warp serves (``per_chain``).  Everything but the copy loops is unrolled, so the static count is a
    tile's once through."""
    text = _sass(smoke)
    if isinstance(text, dict):
        return text
    out = {}
    for d in K3_SASS_WIDTHS:
        found = re.findall(rf"Function : (\S*chol_inv_logdet_kernel\S*WidthILi{d}ELb1E\S*)(.*?)(?=Function :|\Z)",
                           text, re.S)
        if len(found) != 1:
            out[f"D{d}"] = {"error": f"{len(found)} chol_inv_logdet_kernel<{d}> in the SASS"}
            continue
        code, _ = _loops(found[0][1])
        ops = [op for _, op, _ in code]
        full = [text_ for _, _, text_ in code]
        row = {"instructions": len(ops), **{key: sum(op in names for op in ops) for key, names in _K3_OPS}}
        for width in ("", ".64", ".128"):
            row[f"lds{width or '.32'}"] = sum(op == "LDS" and re.match(rf"LDS(\.U)?{re.escape(width)}(\s|$)",
                                                                     t.split()[0] + " ") is not None
                                               for op, t in zip(ops, full))
        geo = smoke.hl.launch_geometry(d)
        chains = max(1, 32 // geo.lanes_per_chain)
        out[f"D{d}"] = {**row, "chains_per_warp": chains,
                        "per_chain": {key: value / chains for key, value in row.items()}}
    return out


def _k3_stamped_lib(smoke):
    """The stamped lab build of this checkout's ``hopper_linalg.cu`` alone (``-DRHMC_K3_STAMPS``), made here
    under ``build/k3_lab/<hash>/`` and never loaded by the port; None where the source has no stamp hooks."""
    import ctypes
    import hashlib

    build = smoke._build
    src = build.CSRC_DIR / "hopper_linalg.cu"
    if "RHMC_K3_STAMPS" not in src.read_text():
        return None
    flags = [*build.NVCC_FLAGS, "-DRHMC_K3_STAMPS", "-shared"]
    key = hashlib.sha256(b"".join(path.read_bytes() for path in [src, *sorted(build.CSRC_DIR.glob("*.cuh"))])
                         + " ".join(flags).encode()).hexdigest()[:16]
    lib_path = build.BUILD_ROOT.parent / "k3_lab" / key / "libk3lab.so"
    if not lib_path.exists():
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([build._nvcc(), *flags, "-o", str(lib_path), str(src)], capture_output=True, text=True,
                              check=False, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"stamped build failed: {proc.stdout[-800:]}{proc.stderr[-800:]}")
        (lib_path.parent / "ptxas.log").write_text(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rhmc_chol_inv_logdet.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr]
    return lib


def _k3_launcher(lib, g):
    """A launch of ``lib``'s K3 on g into outputs allocated once, on the current stream."""
    import torch

    c, d, _ = g.shape
    l, inv, half = torch.empty_like(g), torch.empty_like(g), torch.empty(c, device=g.device)

    def launch():
        err = lib.rhmc_chol_inv_logdet(g.data_ptr(), l.data_ptr(), inv.data_ptr(), half.data_ptr(), c, d,
                                       torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"lab K3 launch failed with CUDA error {err}")
    return launch, (l, inv, half)


def _k3_phases(smoke, c: int, d: int) -> dict:
    """K3's phase split at (C, D) from a lab build with -DRHMC_K3_STAMPS (``_k3_stamped_lib``): lane 0 of each
    warp adds the clock64() cycles of each phase over its tiles and keeps %globaltimer at its start and end.
    Per warp that ran, averaged: the cycles of each phase and their shares; the warps' spans (ns) and the
    kernel's (first start to last end).  ``{"error": ...}`` for a checkout without the hooks."""
    import ctypes

    import numpy as np
    import torch

    lib = _k3_stamped_lib(smoke)
    if lib is None:
        return {"error": "no stamp hooks in this checkout's K3"}
    lib.rhmc_k3_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    phases = ("wait_g", "factor", "store_l", "subst", "product", "store_inv")
    g, _ = smoke.spd_batch(c, d, seed=d)
    launch, _ = _k3_launcher(lib, g)
    launch()  # warm
    torch.cuda.synchronize()
    if lib.rhmc_k3_stamps_reset() != 0:
        raise RuntimeError("stamps reset failed")
    launch()
    torch.cuda.synchronize()
    warps = 1 << 15
    host = np.zeros((warps, len(phases) + 3), dtype=np.uint64)
    if lib.rhmc_k3_stamps(host.ctypes.data, warps) != 0:
        raise RuntimeError("reading the stamps failed")
    ran = host[host[:, len(phases)] > 0].astype(np.float64)
    cycles = ran[:, : len(phases)]
    start, end = ran[:, -2], ran[:, -1]
    per_warp = cycles.sum(1)
    return {"warps": int(len(ran)), "tiles_per_warp": float(ran[:, len(phases)].mean()),
            "cycles": {p: float(v) for p, v in zip(phases, cycles.mean(0))},
            "share": {p: float(v) for p, v in zip(phases, cycles.mean(0) / per_warp.mean())},
            "warp_cycles_mean": float(per_warp.mean()), "warp_cycles_max": float(per_warp.max()),
            "warp_span_ns_mean": float((end - start).mean()), "kernel_span_ns": float(end.max() - start.min()),
            "start_spread_ns": float(start.max() - start.min()), "sm_clock_max_mhz": smoke.sm_clock_max_mhz()}


def _latent_system(smoke, b: int, t: int, case: str):
    """(diag, off) of HMC's identity mass as the sampler makes it, or of the latent metric, its off-diagonal an
    expanded view as the model makes it."""
    import torch

    if case == "identity":
        return torch.ones((b, t), device=smoke.DEVICE), torch.zeros((b, t - 1), device=smoke.DEVICE)
    return smoke.bidiag_inputs(b, t, seed=b + t)


def _measure_bidiag(smoke) -> list[dict]:
    import torch

    tridiag, card, rows = smoke.rt.ops.tridiag, smoke.smi_line(), []
    if hasattr(tridiag, "solve_cuda"):
        route = "T1 on the pivots, off through its strides"
    elif hasattr(tridiag, "cholesky_cuda"):
        route = "T1 on ld, off copied"
    else:
        route = "loop of three launches a position"
    with torch.inference_mode():
        for b, t, case in BIDIAG_RUNS:
            diag, off = _latent_system(smoke, b, t, case)
            bound, bound_by = smoke.bidiag_bound_us(b, t)
            row = _captured(smoke, lambda: tridiag.cholesky(diag, off))
            rows.append({"kernel": "bidiag", "B": b, "T": t, "G": case, "route": route, **row, "bound_us": bound,
                         "bound_by": bound_by, "share_of_bound": bound / row["device_us"], "card": card})
    return rows


def _measure_pcr(smoke) -> list[dict]:
    import torch

    tridiag, card, rows = smoke.rt.ops.tridiag, smoke.smi_line(), []
    route = "T2" if hasattr(tridiag, "solve_cuda") else "plain PCR, elementwise launches"
    with torch.inference_mode():
        for b, t, case in PCR_RUNS:
            diag, off = _latent_system(smoke, b, t, case)
            gen = torch.Generator(device=smoke.DEVICE).manual_seed(t)
            rhs = torch.randn((b, t), generator=gen, device=smoke.DEVICE)
            bound, bound_by = smoke.pcr_bound_us(b, t)
            row = _captured(smoke, lambda: tridiag.solve(diag, off, rhs))
            rows.append({"kernel": "pcr", "B": b, "T": t, "G": case, "route": route, **row, "bound_us": bound,
                         "bound_by": bound_by, "share_of_bound": bound / row["device_us"], "card": card})
    if route == "T2":
        rows.append({"kernel": "pcr_round_loop", "card": card, **_pcr_round_loop(smoke)})
    return rows


def _measure_linalg(smoke) -> list[dict]:
    import torch

    hl = smoke.hl
    public_layout = hasattr(hl, "launch_geometry")
    lib, card, rows = hl._lib(), smoke.smi_line(), []
    with torch.inference_mode():
        for c, d in smoke.TIMED_SHAPES:
            g, b = smoke.spd_batch(c, d, seed=d)
            gk, bk = (g, b) if public_layout else (g.permute(1, 2, 0).contiguous(), b.T.contiguous())
            l, x, logdet = torch.empty_like(gk), torch.empty_like(bk), torch.empty(c, device=g.device)
            calls = {
                "cholesky": (lambda: hl.cholesky_cuda(g),
                             lambda: hl._launch("cholesky", lib.rhmc_cholesky, (gk, l), c, d)),
                "chol_solve_logdet": (lambda: hl.chol_solve_logdet_cuda(g, b),
                                      lambda: hl._launch("chol_solve_logdet", lib.rhmc_chol_solve_logdet,
                                                         (gk, bk, x, logdet), c, d)),
            }
            for name, (wrapper, launch) in calls.items():
                dev, whole = smoke.device_us(launch, name_part=smoke.KERNEL_NAMES[name]), smoke.device_us(wrapper)
                bound, _ = smoke.bound_us(name, c, d)
                rows.append({
                    "kernel": name, "C": c, "D": d, "layout": "public" if public_layout else "chains-last",
                    "ms": smoke.median_ms(wrapper), "burst_ms": smoke.burst_ms(wrapper),
                    "kernel_only_ms": smoke.burst_ms(launch), "device_us": dev["us"],
                    "device_us_source": dev["source"], "wrapper_device_us": whole["us"],
                    "wrapper_device_kernels": whole["events_per_call"], "bound_us": bound,
                    "share_of_bound": bound / dev["us"], "card": card,
                })
    return rows


def _measure_fhn(smoke) -> list[dict]:
    import torch

    fs, data, card, rows = smoke.rt.ops.fhn_sens, smoke.fhn_data(), smoke.smi_line(), []
    truth = torch.tensor(smoke.rt.models.fhn.THETA_TRUE, device=smoke.DEVICE)
    with torch.inference_mode():
        for c in FHN_CHAINS:
            gen = torch.Generator(device=smoke.DEVICE).manual_seed(c)
            theta = truth * (1.0 + 0.05 * torch.randn((c, 3), generator=gen, device=smoke.DEVICE))
            for order in fs.ORDERS:
                def launch():
                    return fs.fhn_sensitivities_cuda(theta, data, order, **smoke.fhn_constants())
                dev = smoke.device_us(launch, launches=20, name_part=smoke.FHN_KERNEL_NAME)
                bound, _, _ = smoke.fhn_bound_us(order, c)
                rows.append({
                    "kernel": "fhn_sensitivities", "C": c, "order": order, "num_obs": smoke.FHN_OBS,
                    "substeps": smoke.FHN_SUBSTEPS, "device_us": dev["us"], "device_us_source": dev["source"],
                    "events_per_call": dev["events_per_call"], "burst_ms": smoke.burst_ms(launch),
                    "ms": smoke.median_ms(launch, reps=20), "bound_us": bound, "share_of_bound": bound / dev["us"],
                    "sm_clock_max_mhz": smoke.sm_clock_max_mhz(), "card": card,
                })
        if not hasattr(fs, "MAX_OBS"):  # a checkout that takes any number of observations
            theta = truth * (1.0 + 0.05 * torch.randn((FHN_CHAINS[0], 3), generator=gen, device=smoke.DEVICE))
            for num_obs, substeps in FHN_LONG:
                data = smoke.fhn_long_data(num_obs)
                for order in fs.ORDERS:
                    def launch():
                        return fs.fhn_sensitivities_cuda(theta, data, order,
                                                         **{**smoke.fhn_constants(), "substeps": substeps})
                    event_us = 1e3 * smoke.burst_ms(launch, launches=5, warmup=1)
                    bound, _, _ = smoke.fhn_bound_us(order, FHN_CHAINS[0], num_obs, substeps)
                    rows.append({
                        "kernel": "fhn_sensitivities", "C": FHN_CHAINS[0], "order": order, "num_obs": num_obs,
                        "substeps": substeps, "device_us": event_us,
                        "device_us_source": "CUDA events, 5 launches back to back", "bound_us": bound,
                        "share_of_bound": bound / event_us, "sm_clock_max_mhz": smoke.sm_clock_max_mhz(),
                        "card": card})
    rows.append({"kernel": "fhn_rk4_loop", "card": card, **_fhn_rk4_loop(smoke)})
    return rows


def _sweep_layouts(gibbs, d: int) -> list[int | None]:
    """The lanes a chain at which to time G1 at width ``d``: a checkout whose
    G1 takes no lanes, its one kernel; else every lane count it takes there
    (B in registers: at most ``SWEEP_ENT_MAX`` entries a lane, where the
    checkout has one)."""
    if not hasattr(gibbs, "SWEEP_LANES"):
        return [None]
    most = getattr(gibbs, "SWEEP_ENT_MAX", None)
    return [lanes for lanes in gibbs.SWEEP_LANES if most is None or -(-d // lanes) <= most]


def _measure_gibbs(smoke) -> list[dict]:
    import torch

    gibbs, truncnorm, card, rows = smoke.gibbs, smoke.truncnorm, smoke.smi_line(), []
    with torch.inference_mode():
        for d in GIBBS_DIMS:
            model, state, cond, noise = smoke.gibbs_inputs(1024, GIBBS_DATA, d, seed=d)
            for c in GIBBS_CHAINS:
                reps = -(-c // 1024)

                def chains(a, axis: int = 0):
                    return torch.cat([a] * reps, dim=axis).narrow(axis, 0, c).contiguous()

                args = (model.X, model.t, chains(state.lam), chains(cond.h), chains(state.z), chains(cond.s),
                        chains(cond.b), truncnorm.TruncNormNoise(*(chains(u, u.dim() - 1) for u in noise)))
                for lanes in _sweep_layouts(gibbs, d):
                    kw = {} if lanes is None else {"lanes": lanes}

                    def launch():
                        return gibbs.gibbs_sweep_cuda(*args, **kw)
                    dev = smoke.device_us(launch, launches=10, name_part=smoke.GIBBS_KERNEL_NAMES["gibbs_sweep"])
                    row = {"kernel": "gibbs_sweep", "C": c, "N": GIBBS_DATA, "D": d, "lanes": lanes,
                           "device_us": dev["us"], "device_us_source": dev["source"],
                           "events_per_call": dev["events_per_call"], "card": card}
                    if lanes is None or lanes == smoke.wrapper_lanes(c):
                        row.update(wrapper_lanes=True, burst_ms=smoke.burst_ms(launch, launches=5, warmup=1))
                    rows.append(row)
        if hasattr(gibbs, "sweep_layout"):  # a checkout whose G1 takes any D
            rows += _measure_gibbs_wide(smoke)
        rows += _measure_gig(smoke)
    rows.append({"kernel": "gibbs_sweep_loop", "card": card, **_gibbs_sweep_loop(smoke)})
    return rows


def _wide_layouts(gibbs, c: int, d: int) -> list[dict | None]:
    """The layouts at which to time G1 past 32 lanes of SWEEP_ENT_MAX entries, as ``gibbs_sweep_cuda``'s
    keywords (None: the wrapper's own): in a checkout whose wide layout is a block of warps a chain, every
    warp count GIBBS_WIDE_WARPS that keeps B in registers and B in shared memory and in the output buffer on
    the wrapper's warps; in an earlier one, its warp a chain with B in shared memory and in the output buffer."""
    if not hasattr(gibbs, "SWEEP_WIDE_REGISTERS"):
        return [None, {"wide": True}, {"wide": True, "b_global": True}]
    warps = [w for w in GIBBS_WIDE_WARPS if -(-d // (gibbs.SWEEP_THREADS * w)) <= gibbs.SWEEP_ENT_MAX]
    return [None, *({"warps": w} for w in warps), {"b_memory": "shared"}, {"b_memory": "global"}]


def _measure_gibbs_wide(smoke) -> list[dict]:
    """G1 past K1's 48 at chip_smoke's SWEEP_WIDE_SHAPES and at D = 32 x SWEEP_ENT_MAX (SWEEP_BOTH_CN), on
    the wrapper's layout and on each of ``_wide_layouts`` past 32 lanes of SWEEP_ENT_MAX entries (and at D =
    32 x SWEEP_ENT_MAX on 32 lanes of registers); in a checkout with a block of warps a chain, also at
    chip_smoke's SWEEP_OPTIN_SHAPE: ``device_us`` (torch.profiler, 5 launches)."""
    gibbs, rows = smoke.gibbs, []
    both = (*smoke.SWEEP_BOTH_CN, gibbs.SWEEP_THREADS * gibbs.SWEEP_ENT_MAX)
    shapes = [*smoke.SWEEP_WIDE_SHAPES, both]
    if hasattr(gibbs, "SWEEP_WIDE_REGISTERS"):
        shapes.append(smoke.SWEEP_OPTIN_SHAPE)
    for c, n, d in shapes:
        model, state, cond, noise = smoke.gibbs_inputs(c, n, d, seed=c + n + d)
        args = (model.X, model.t, state.lam, cond.h, state.z, cond.s, cond.b, noise)
        wide = d > gibbs.SWEEP_THREADS * gibbs.SWEEP_ENT_MAX
        kinds = _wide_layouts(gibbs, c, d) if wide else [None]
        if (c, n, d) == both:
            kinds = [None, *_wide_layouts(gibbs, c, d)[1:]]  # the register layout and every wide one
        for kind in kinds:
            kw = kind or {}

            def launch():
                return gibbs.gibbs_sweep_cuda(*args, **kw)
            layout, code = gibbs.launch_layout(c, d, smoke.torch.device(smoke.DEVICE), **kw)
            dev = smoke.device_us(launch, launches=5, name_part=smoke.GIBBS_KERNEL_NAMES["gibbs_sweep"])
            rows.append({"kernel": "gibbs_sweep", "C": c, "N": n, "D": d, "layout": kind or "wrapper",
                         "lanes": layout.lanes, "entries": layout.entries, "code": code,
                         "device_us": dev["us"], "device_us_source": dev["source"],
                         "events_per_call": dev["events_per_call"], "card": smoke.smi_line()})
        del model, state, cond, noise, args
    return rows


def _measure_gig(smoke) -> list[dict]:
    """The GIG draw of a Gibbs step as each checkout runs it (``ops.sample_gig_half``
    at chip_smoke's GIG_SHAPE, r^2 log-uniform over [1e-4, 25]): one call's
    device time (every device event: the draws, the rounds, the key) and its
    CUDA-event time, one call and a burst."""
    import torch

    r = smoke.gig_inputs(seed=7)[0]
    r2 = r * r
    gen = torch.Generator(device=smoke.DEVICE).manual_seed(0)

    def call():
        return smoke.gig.sample_gig_half(gen, r2)
    dev = smoke.device_us(call, launches=5)
    return [{"kernel": "gig", "C": r.shape[0], "N": r.shape[1], "device_us": dev["us"],
             "device_events_per_call": dev["events_per_call"], "ms": smoke.median_ms(call, reps=10, warmup=2),
             "burst_ms": smoke.burst_ms(call, launches=10, warmup=2), "card": smoke.smi_line()}]


def _sass(smoke) -> str | dict:
    """The built library's SASS (``cuobjdump -sass``), or ``{"error": ...}``."""
    cuobjdump = Path(smoke._build._nvcc()).parent / "cuobjdump"
    if not cuobjdump.exists():
        return {"error": f"no {cuobjdump}"}
    proc = subprocess.run([str(cuobjdump), "-sass", str(smoke._build.build())], capture_output=True, text=True,
                          check=False, timeout=600)
    if proc.returncode != 0:
        return {"error": f"cuobjdump exited {proc.returncode}: {proc.stderr[-500:]}"}
    return proc.stdout


def _loops(body: str):
    """A function's SASS as (address, opcode, operands) and its loops as (first, last) addresses."""
    code = [(int(addr, 16), op.split(".")[0], op + rest) for addr, op, rest in
            re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", body)]
    loops = [(int(target, 16), addr) for addr, op, rest in code if op == "BRA"
             for target in re.findall(r"0x([0-9a-f]+)", rest) if int(target, 16) < addr]
    return code, loops


def _pcr_round_loop(smoke) -> dict:
    """T2's round loop through shared memory as each build compiled it, in the instantiation that
    PCR_RUNS' T = 2000 launches: the loop holding the barriers, its SASS instructions once through (the
    IEEE divisions' out-of-line slow paths excluded, their calls included) over the positions a thread, and
    the divisions' checks (FCHK) and calls of their slow paths, the branch and reconvergence instructions,
    the shared-memory loads and stores and the barriers in it."""
    text = _sass(smoke)
    if isinstance(text, dict):
        return text
    per = smoke.rt.ops.tridiag.pcr_geometry(PCR_RUNS[0][1]).per_thread
    found = re.findall(rf"Function : (\S*pcr_solve_kernelILi{per}E\S*)(.*?)(?=Function :|\Z)", text, re.S)
    if len(found) != 1:
        return {"error": f"{len(found)} pcr_solve_kernel<{per}> in the SASS"}
    code, loops = _loops(found[0][1])
    barred = [(lo, hi) for lo, hi in loops if any(lo <= a <= hi and op == "BAR" for a, op, _ in code)]
    if not barred:
        return {"error": "no loop with a barrier"}
    lo, hi = max(barred, key=lambda span: span[1] - span[0])
    inside = [op for a, op, _ in code if lo <= a <= hi]
    return {"per_thread": per, "instructions_a_position": len(inside) / per,
            **{key: sum(op in ops for op in inside) for key, ops in
               (("fchk", ("FCHK",)), ("calls", ("CALL",)), ("control", _CONTROL), ("lds", ("LDS",)),
                ("sts", ("STS",)), ("bar", ("BAR",)), ("mufu", ("MUFU",)))}}


# D 15 and 40 on 32 to 1 lanes a chain; on a block of warps, D 1,088 and 2,049 on 8 warps (5, 9) and 2,049 on 2 (33)
GIBBS_LOOP_ENTRIES = (1, 2, 3, 4, 5, 8, 9, 10, 15, 20, 33, 40)
_CONTROL = ("BRA", "BSSY", "BSYNC", "WARPSYNC", "CALL", "BRX", "JMP")  # branch and reconvergence opcodes


def _gibbs_sweep_loop(smoke) -> dict:
    """G1's step loop as each build compiled it: per instantiation at the
    entries of GIBBS_LOOP_ENTRIES, the loop over the steps (the largest
    loop), its SASS instructions once through (the tail's
    rounds and the group's shuffle loop included, each once), the branch and
    reconvergence instructions inside bar the loop's own, its shuffles and its
    MUFU (logarithm, square root, reciprocal, exponential) instructions."""
    text = _sass(smoke)
    if isinstance(text, dict):
        return text
    out = {}
    for name, body in re.findall(r"Function : (\S*gibbs_sweep_(?:block_|memory_|wide_)?kernel\S*)(.*?)"
                                 r"(?=Function :|\Z)", text, re.S):
        found = re.search(r"gibbs_sweep_(block_|memory_|wide_)?kernelI(?:Li(\d+)E)?((?:Lb[01]E)*)E", name)
        if not found or (found.group(2) and int(found.group(2)) not in GIBBS_LOOP_ENTRIES):
            continue
        form, ent, flags = found.groups()
        flags = re.findall(r"Lb([01])E", flags)
        if form and ent:  # the wide layout on a block of warps, by entries a lane (and its template's flags)
            key = f"{form[:-1]}<{ent}>" if set(flags) <= {"0"} else f"{form[:-1]}<{ent},{''.join(flags)}>"
        elif form:  # B in memory (shared / global)
            key = f"{form[:-1]}<{'shared' if flags == ['1'] else 'global'}>"
        else:
            key = f"<{ent}>" if flags in ([], ["0"]) else f"<{ent},prologue>"  # prologue: a chain on a whole warp
        code, loops = _loops(body)
        if not loops:
            continue
        lo, hi = max(loops, key=lambda span: span[1] - span[0])
        inside = [(op, text_) for a, op, text_ in code if lo <= a <= hi]
        out[key] = {"instructions": len(inside),
                    "branches": sum(op in _CONTROL for op, _ in inside) - 1,
                    "shuffles": sum(op == "SHFL" for op, _ in inside),
                    "mufu": sum(op == "MUFU" for op, _ in inside),
                    "loads": sum(op in ("LDG", "LD", "LDS") for op, _ in inside)}
    return out


def _fhn_rk4_loop(smoke) -> dict:
    """Per order, the FHN kernel's RK4 step loop in the built library's SASS:
    the innermost loop (a backward branch) with the most FFMAs, the RK4 steps
    it takes per pass (its multiplies by 1/3, one per right-hand side, over
    4: nvcc may unroll it), its instructions per step, and the branch and
    reconvergence instructions inside it bar the loop's own (none expected:
    the lanes of a chain hold different roles, so a branch on the role runs
    each side in turn).  ``{"error": ...}`` where cuobjdump is missing or fails."""
    cuobjdump = Path(smoke._build._nvcc()).parent / "cuobjdump"
    if not cuobjdump.exists():
        return {"error": f"no {cuobjdump}"}
    proc = subprocess.run([str(cuobjdump), "-sass", str(smoke._build.build())], capture_output=True, text=True,
                          check=False, timeout=300)
    if proc.returncode != 0:
        return {"error": f"cuobjdump exited {proc.returncode}: {proc.stderr[-500:]}"}
    out = {}
    name = smoke.FHN_KERNEL_NAME
    for order, kind, body in re.findall(rf"Function : \S*{name}ILi(\d)E(?:Lb([01])E)?E\S*(.*?)(?=Function :|\Z)",
                                        proc.stdout, re.S):
        code = [(int(addr, 16), op.split(".")[0], rest) for addr, op, rest in
                re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", body)]
        loops = [(int(target, 16), addr) for addr, op, rest in code if op == "BRA"
                 for target in re.findall(r"0x([0-9a-f]+)", rest) if int(target, 16) < addr]
        innermost = [(lo, hi) for lo, hi in loops if not any(lo <= a < b <= hi and (a, b) != (lo, hi) for a, b in loops)]
        bodies = [[(op, rest) for addr, op, rest in code if lo <= addr <= hi] for lo, hi in innermost]
        if not bodies:
            continue
        inside = max(bodies, key=lambda b: sum(op == "FFMA" for op, _ in b))
        steps = sum("0.333333" in rest for _, rest in inside) / 4
        out[f"fhn<{order}>" if kind in ("", "1") else f"fhn<{order},streamed>"] = {
            "steps_per_pass": steps, "instructions_per_step": len(inside) / steps if steps else None,
            "branches": sum(op in ("BRA", "BSSY", "BSYNC", "WARPSYNC") for op, _ in inside) - 1}
    return out


def _fixed_point_call(smoke, inp: dict, name: str, rounds: int, fused: bool):
    """One call of a fixed point on ``inp`` as the checkout computes it: its kernels K4 / K5 (``fused``, at every
    width, whatever route the model takes there) or the sampler's loops (Gaussian momentum, no jitter): the
    checkout's plain versions where it has them, else the loops as that checkout wrote them."""
    ops, model, dt = smoke.rt.ops, inp["model"], inp["dt"]
    w, inv, cache, p, base, u0 = (inp[k] for k in ("w", "inv", "cache", "p", "base", "u0"))
    plain = getattr(ops, "logreg_fixed_point", None)
    if fused and name == "position_fixed_point":
        return lambda: plain.position_fixed_point_cuda(model.X, w, p, u0, dt, alpha=model.alpha, rounds=rounds)
    if fused:
        return lambda: plain.momentum_fixed_point_cuda(model.X, inv, cache, p, p, base, dt, rounds=rounds)
    if plain is not None and name == "position_fixed_point":
        return lambda: plain.position_fixed_point_plain(model, w, p, u0, dt, rounds=rounds)
    if plain is not None:
        return lambda: plain.momentum_fixed_point_plain(model, w, inv, cache, p, p, base, dt, rounds=rounds)
    half = 0.5 * dt[:, None]

    def position():
        wf = w
        for _ in range(rounds):
            wf = w + half * (u0 + ops.solve_psd(model.metric(wf), p))
        return wf

    def momentum():
        pm = p
        for _ in range(rounds):
            u = smoke.torch.einsum("...ab,...b->...a", inv, pm)
            pm = p + half * (base + 0.5 * model.dg_bilinear(w, u, u, cache=cache))
        return pm

    return position if name == "position_fixed_point" else momentum


def _measure_fixed_point(smoke) -> list[dict]:
    import torch

    fused = hasattr(smoke.rt.models.LogisticRegression, "position_fixed_point")
    routes = [("K4 / K5", True), ("loops", False)] if fused else [("loops", False)]
    card, rows = smoke.smi_line(), []
    with torch.inference_mode():
        for c, n, d in FIXED_POINT_RUNS:
            inp = smoke.fixed_point_inputs(c, n, d, seed=50)
            for route, kernel in routes:
                for label, name, rounds in (("position_fixed_point", "position_fixed_point", 4),
                                            ("momentum_fixed_point", "momentum_fixed_point", 4),
                                            ("momentum_half_step", "momentum_fixed_point", 1)):
                    row = _captured(smoke, _fixed_point_call(smoke, inp, name, rounds, kernel))
                    bound, bound_by = smoke.fixed_point_bound_us(name, c, n, d, rounds)
                    rows.append({"kernel": label, "C": c, "N": n, "D": d, "rounds": rounds, "route": route, **row,
                                 "bound_us": bound, "bound_by": bound_by,
                                 "share_of_bound": bound / row["device_us"], "card": card})
            del inp
    if fused:
        rows.append({"kernel": "fixed_point_loops", "card": card, **_fixed_point_loops(smoke)})
        rows += [{"kernel": "k4_phases", "C": c, "N": n, "D": d, "card": card, **_k4_phases(smoke, c, n, d)}
                 for c, n, d in K4_PHASE_RUNS]
        rows += _fixed_point_rounds(smoke, card)
    return rows


def _fixed_point_rounds(smoke, card: str) -> list[dict]:
    """K4's and K5's own device time (torch.profiler, by name) at the main shape against the rounds of one launch,
    ``FIXED_POINT_ROUND_COUNTS``: the slope is a round's cost, the rest the launch's (staging, the first round's
    copies); K5's one-round form reads c from device memory, its other forms stage it."""
    import torch

    c, n, d = FIXED_POINT_RUNS[0]
    inp = smoke.fixed_point_inputs(c, n, d, seed=50)
    model, w, inv, cache, p, base, u0, dt = (inp[k] for k in ("model", "w", "inv", "cache", "p", "base", "u0", "dt"))
    rows = []
    with torch.inference_mode():
        for label, name in (("position_fixed_point", "position_fixed_point_kernel"),
                            ("momentum_fixed_point", "momentum_fixed_point_kernel")):
            us = {}
            for rounds in FIXED_POINT_ROUND_COUNTS:
                if label == "position_fixed_point":
                    call = lambda: model.position_fixed_point(w, p, u0, dt, rounds=rounds)  # noqa: E731
                else:
                    call = lambda: model.momentum_fixed_point(w, inv, cache, p, p, base, dt, rounds=rounds)  # noqa: E731
                us[rounds] = smoke.device_us(call, launches=20, name_part=name)["us"]
            rows.append({"kernel": f"{label}_rounds", "C": c, "N": n, "D": d, "device_us_by_rounds": us, "card": card})
    return rows


def _rows_per_pass(smoke, kernel: str, d: int) -> int:
    """Rows of X one pass of ``kernel``'s round loop covers in a thread, from the checkout's layout mirror."""
    lfp = smoke.rt.ops.logreg_fixed_point
    if hasattr(lfp, "k4_tiles"):
        return lfp.k4_tiles(d).rows_per_set if "position" in kernel else lfp.K5_PASS // 32
    return lfp.k4_build(d).chunk if "position" in kernel else 1


def _fixed_point_loops(smoke) -> dict:
    """K4's and K5's round loops at FIXED_POINT_SASS_WIDTHS as the build compiled them: per kernel the loop without
    shuffles with the most FFMAs of its own (nested loops' instructions left out: K4's chunk of products, K5's pass
    of rows),
    its SASS instructions, FFMAs and their share, shared loads by width, shuffles and branch / reconvergence
    instructions, each also a row of X (``per_row``: over the rows one pass covers), and the kernel's static
    instructions, registers and spill from ptxas."""
    text = _sass(smoke)
    if isinstance(text, dict):
        return text
    log = (smoke._build.build().parent / "ptxas.log").read_text()
    out = {}
    for name in smoke.FIXED_POINT_KERNEL_NAMES.values():
        for d in FIXED_POINT_SASS_WIDTHS:
            key = f"{name}<{d}>"
            found = re.findall(rf"Function : (\S*{name}INS_5WidthILi{d}ELb1EEE\S*)(.*?)(?=Function :|\Z)", text, re.S)
            if len(found) != 1:
                out[key] = {"error": f"{len(found)} {key} in the SASS"}
                continue
            code, loops = _loops(found[0][1])
            own = []
            for lo, hi in loops:
                nested = [(a, b) for a, b in loops if lo <= a <= b <= hi and (a, b) != (lo, hi)]
                own.append([(op, rest) for a, op, rest in code
                            if lo <= a <= hi and not any(x <= a <= y for x, y in nested)])
            regs = re.findall(rf"{name}INS_5WidthILi{d}ELb1EEE.*?(\d+) bytes spill stores.*?Used (\d+) registers", log,
                              re.S)
            if not own:
                out[key] = {"error": "no loop"}
                continue
            # the round loop of rows, not the factor's or the exchange's unrolled shuffles
            rows_loops = [b for b in own if not any(op == "SHFL" for op, _ in b)] or own
            inside = max(rows_loops, key=lambda b: sum(op == "FFMA" for op, _ in b))
            counts = {
                "instructions": len(inside), "ffma": sum(op == "FFMA" for op, _ in inside),
                "lds_32": sum(op == "LDS" and not re.search(r"\.(64|128)\b", rest.split()[0]) for op, rest in inside),
                "lds_64": sum(op == "LDS" and ".64" in rest.split()[0] for op, rest in inside),
                "lds_128": sum(op == "LDS" and ".128" in rest.split()[0] for op, rest in inside),
                "shfl": sum(op == "SHFL" for op, _ in inside), "control": sum(op in _CONTROL for op, _ in inside)}
            rows = _rows_per_pass(smoke, name, d)
            out[key] = {**counts, "ffma_share": counts["ffma"] / max(1, counts["instructions"]), "rows_per_pass": rows,
                        "per_row": {k: v / rows for k, v in counts.items()},
                        "registers": int(regs[0][1]) if regs else None,
                        "spill_store_bytes": int(regs[0][0]) if regs else None, "kernel_instructions": len(code)}
    return out


def _k4_stamped_lib(smoke):
    """The stamped lab build of this checkout's ``logreg_fixed_point.cu`` alone (``-DRHMC_K4_STAMPS``), made here
    under ``build/k4_lab/<hash>/`` and never loaded by the port; None where the source has no stamp hooks."""
    import ctypes
    import hashlib

    build = smoke._build
    src = build.CSRC_DIR / "logreg_fixed_point.cu"
    if "RHMC_K4_STAMPS" not in src.read_text():
        return None
    flags = [*build.NVCC_FLAGS, "-DRHMC_K4_STAMPS", "-shared"]
    key = hashlib.sha256(b"".join(path.read_bytes() for path in [src, *sorted(build.CSRC_DIR.glob("*.cuh"))])
                         + " ".join(flags).encode()).hexdigest()[:16]
    lib_path = build.BUILD_ROOT.parent / "k4_lab" / key / "libk4lab.so"
    if not lib_path.exists():
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([build._nvcc(), *flags, "-o", str(lib_path), str(src)], capture_output=True, text=True,
                              check=False, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"stamped build failed: {proc.stdout[-800:]}{proc.stderr[-800:]}")
        (lib_path.parent / "ptxas.log").write_text(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rhmc_position_fixed_point.argtypes = [ptr] * 6 + [i32, i32, i32, f32, f32, i32, i32, ptr]
    lib.rhmc_k4_stamps.argtypes = [ptr, i32]
    return lib


def _k4_phases(smoke, c: int, n: int, d: int) -> dict:
    """K4's phase split at (C, N, D), 4 rounds, from the stamped lab build (``_k4_stamped_lib``): thread 0 of each
    block adds the clock64() cycles of each phase over the rounds and keeps %globaltimer at its start and end.
    Per block, averaged: the cycles of each phase and their shares; the blocks' spans (ns) and the kernel's
    (first start to last end).  ``{"error": ...}`` for a checkout without the hooks."""
    import numpy as np
    import torch

    lib = _k4_stamped_lib(smoke)
    if lib is None:
        return {"error": "no stamp hooks in this checkout's K4"}
    # the checkout's phases, as its source names them (kWaitX -> wait_x)
    (names,) = re.findall(r"enum K4Phase \{([^}]*)\}", (smoke._build.CSRC_DIR / "logreg_fixed_point.cu").read_text())
    phases = tuple(re.sub(r"(?<!^)([A-Z])", r"_\1", n.strip()[1:]).lower() for n in names.split(",")
                   if n.strip() != "kK4Phases")
    inp = smoke.fixed_point_inputs(c, n, d, seed=50)
    x, w, p, u0, dt = inp["model"].X, inp["w"], inp["p"], inp["u0"], inp["dt"]
    out = torch.empty_like(w)
    inv_alpha = float(torch.tensor(1.0, dtype=torch.float32) / torch.tensor(inp["model"].alpha, dtype=torch.float32))

    def launch():
        err = lib.rhmc_position_fixed_point(x.data_ptr(), w.data_ptr(), p.data_ptr(), u0.data_ptr(), dt.data_ptr(),
                                            out.data_ptr(), c, n, d, inv_alpha, 0.0, 4, 0,
                                            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"lab K4 launch failed with CUDA error {err}")
    launch()  # warm
    torch.cuda.synchronize()
    if lib.rhmc_k4_stamps_reset() != 0:
        raise RuntimeError("stamps reset failed")
    launch()
    torch.cuda.synchronize()
    blocks = 1 << 12
    host = np.zeros((blocks, len(phases) + 3), dtype=np.uint64)
    if lib.rhmc_k4_stamps(host.ctypes.data, blocks) != 0:
        raise RuntimeError("reading the stamps failed")
    ran = host[host[:, len(phases)] > 0].astype(np.float64)
    cycles = ran[:, : len(phases)]
    start, end = ran[:, -2], ran[:, -1]
    per_block = cycles.sum(1)
    return {"blocks": int(len(ran)), "rounds": float(ran[:, len(phases)].mean()),
            "cycles": {q: float(v) for q, v in zip(phases, cycles.mean(0))},
            "share": {q: float(v) for q, v in zip(phases, cycles.mean(0) / per_block.mean())},
            "block_cycles_mean": float(per_block.mean()), "block_cycles_max": float(per_block.max()),
            "block_span_ns_mean": float((end - start).mean()), "kernel_span_ns": float(end.max() - start.min()),
            "start_spread_ns": float(start.max() - start.min()), "sm_clock_max_mhz": smoke.sm_clock_max_mhz()}


def _with_critical_path(row: dict) -> dict:
    """An FHN row with this checkout's critical path, the same yardstick for both checkouts."""
    from riemannhamiltonianmontecarlo_tpu_torch.ops import fhn_sens

    path = fhn_sens.critical_path_us(row["num_obs"], row["substeps"], row["sm_clock_max_mhz"])
    return {**row, "critical_path_us": path, "share_of_critical_path": path / row["device_us"]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--parent", type=Path, help="the other checkout")
    ap.add_argument("--kernels", default="linalg", help=f"comma-separated subset of {','.join(KERNELS)}")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    ap.add_argument("--measure", type=Path, default=None, help=argparse.SUPPRESS)  # the child's mode
    args = ap.parse_args(argv)
    kernels = [k for k in args.kernels.split(",") if k]
    if not kernels or set(kernels) - set(KERNELS):
        ap.error(f"--kernels takes a comma-separated subset of {','.join(KERNELS)}, got {args.kernels!r}")
    if args.measure is not None:
        print(json.dumps(_measure(args.measure, kernels)), flush=True)
        return
    if args.parent is None:
        ap.error("--parent is required")
    roots = {"parent": args.parent.resolve(), "change": REPO}
    lines = []
    for turn, which in enumerate(TURNS):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--measure", str(roots[which]),
                               "--kernels", args.kernels], capture_output=True, text=True, check=False, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"turn {turn} ({which}) failed:\n{proc.stdout}\n{proc.stderr}")
        for row in json.loads(proc.stdout.strip().splitlines()[-1]):
            if row["kernel"] == "fhn_sensitivities":
                row = _with_critical_path(row)
            lines.append(json.dumps({"turn": turn, "which": which, **row}))
            print(lines[-1], flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
