"""Run the joint (sigma^2, beta, x) LGC samplers at the reference 64 x 64 size.

Port of ``tools/run_lgc_joint.py``.  The paper's most expensive
configuration (main_article.pdf sec. 8: "5000 posterior samples taking
around 90 h of computation time"; ``LGC_RMHMC_Paras_LV.m:41-47``, mMALA
variant ``LGC_mMALA_Paras_LV.m:42-43``).  No per-method ESS table exists for
it, so the headline comparison is wall clock per posterior sample against
the paper's ~64.8 s on its CPU (324000 s / 5000), beside the measured hyper /
latent ESS and s/minESS.

Usage::

    python -m riemannhamiltonianmontecarlo_tpu_torch.tools.run_lgc_joint \\
        --method rmhmc --chains 4 --samples 5000 --burn-in 1000 --device cuda \\
        [--calibrate] [--out FILE]

Protocol: the authors' data (``TestData64.mat`` in ``$RHMC_DATA_DIR``) when
present, else the generated draw; the run goes in segments of ``--seg``
sweeps, and after each the kernel state goes to disk through
``utils.checkpoint`` with the segment's samples beside it, so a killed run
resumes from the last finished segment.  Segment i draws from
``parallel.segment_generator(seed, i)``: the resumed run's samples are the
uninterrupted run's, bit for bit.

Differences from the JAX package's tool:

* it never writes ``RESULTS.md`` (the JAX package's record): it prints the
  section, or writes it to ``--out FILE``, headed by the device's name and,
  on a CUDA device, the card's name and power limit as ``nvidia-smi`` gives
  them;
* no segment is excused for compilation (nothing compiles): the steady
  time per segment is the median over all sampling segments, times their
  count;
* every segment's seconds, acceptance and divergences are kept in the state
  checkpoint itself (one atomic file, no separate metadata file), so the
  divergence count survives a resume;
* the acceptance is averaged over the sweeps of the sampling segments, a
  segment that straddles the end of the burn-in counted whole;
* ``--device`` (default ``cuda``): a CUDA request without a card is an
  error, there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from riemannhamiltonianmontecarlo_tpu_torch import interop, parallel
from riemannhamiltonianmontecarlo_tpu_torch.diagnostics import ess_geyer_device
from riemannhamiltonianmontecarlo_tpu_torch.experiments import resolve_device
from riemannhamiltonianmontecarlo_tpu_torch.models import lgc
from riemannhamiltonianmontecarlo_tpu_torch.models.datasets import find_data_file
from riemannhamiltonianmontecarlo_tpu_torch.samplers import lgc_joint
from riemannhamiltonianmontecarlo_tpu_torch.tools.common import device_line, fmt, synchronize
from riemannhamiltonianmontecarlo_tpu_torch.utils import checkpoint as ckpt

PAPER_SECONDS_PER_SAMPLE = 324000.0 / 5000.0  # ~90 h / 5000 samples, the article's CPU
DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[2] / "build" / "lgc_joint_ckpt"  # git-ignored

HEADER = ("| sampler | chains | samples | accept | divergent | block | total ESS "
          "(min, med, max) | s/minESS | wall (s) | s/sample | paper s/sample "
          "| speedup |\n|---|---|---|---|---|---|---|---|---|---|---|---|")


def _collect_theta_x(st):
    return (st.position, st.x)


def run_segmented(kernel, init, *, burn_in, num_samples, seg, seed, ckpt_dir, tag, _stop_after_segments=None):
    """Segmented run with disk checkpoints.

    Returns (theta (C, S, 2), x (C, S, D), accept, divergences, seconds) as
    NumPy arrays and numbers; seconds is the median wall clock of a
    sampling segment times their count.  After each segment one file,
    ``<tag>.state.npz``, takes the kernel state, the number of segments done
    and every sampling segment's seconds, acceptance and divergences
    (written atomically: a kill leaves the last whole segment), and
    ``<tag>.seg<i>.npz`` the segment's samples.  ``_stop_after_segments``
    simulates a kill after that many segments of this call (tests only):
    the call then returns None.
    """
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    state_f = ckpt_dir / f"{tag}.state.npz"
    device = init.device
    total = burn_in + num_samples
    n_seg = -(-total // seg)

    def seg_file(i: int) -> Path:
        return ckpt_dir / f"{tag}.seg{i}.npz"

    # Per segment; a burn-in segment keeps its zeros.
    stats = {k: torch.zeros(n_seg, dtype=torch.float64) for k in ("seconds", "accept_sum", "sweeps", "divergences")}
    start_seg, state = 0, None
    if ckpt.checkpoint_exists(state_f):
        with torch.inference_mode():
            template = kernel.init(init)
        (state, stats), start_seg, _ = ckpt.load_state(state_f, (template, stats))
        print(f"[{tag}] resumed at segment {start_seg}/{n_seg}", flush=True)

    for i in range(start_seg, n_seg):
        if _stop_after_segments is not None and i - start_seg >= _stop_after_segments:
            return None
        lo, hi = i * seg, min((i + 1) * seg, total)
        n = hi - lo
        collecting = hi > burn_in
        synchronize(device)
        t0 = time.perf_counter()
        r = parallel.run(kernel, parallel.segment_generator(seed, i, device), init if state is None else None,
                         num_samples=n, collect=collecting, init_state=state,
                         collect_fn=_collect_theta_x if collecting else None)
        state = r.final_state
        synchronize(device)
        dt = time.perf_counter() - t0
        if collecting:
            keep = max(burn_in - lo, 0)  # drop any burn-in inside the segment
            np.savez(seg_file(i), theta=r.samples[0][:, keep:].cpu().numpy(), x=r.samples[1][:, keep:].cpu().numpy())
            for name, value in (("seconds", dt), ("accept_sum", float(r.accept_rate) * n), ("sweeps", n),
                                ("divergences", int(r.divergences))):
                stats[name][i] = value
        ckpt.save_state(state_f, (state, stats), step=i + 1)
        print(f"[{tag}] seg {i + 1}/{n_seg}  {dt:.1f}s  accept={float(r.accept_rate):.3f}  "
              f"kept={max(hi - burn_in, 0)}/{num_samples}", flush=True)

    sampled = stats["sweeps"] > 0
    theta_parts, x_parts = [], []
    for i in sampled.nonzero().flatten().tolist():
        with np.load(seg_file(i)) as d:
            theta_parts.append(d["theta"])
            x_parts.append(d["x"])
    theta = np.concatenate(theta_parts, axis=1)
    x = np.concatenate(x_parts, axis=1)
    t_sampling = float(stats["seconds"][sampled].median()) * int(sampled.sum())
    accept = float(stats["accept_sum"].sum() / stats["sweeps"].sum())
    return theta, x, accept, int(stats["divergences"].sum()), t_sampling


def ess_stats(samples_np: np.ndarray, device: torch.device) -> tuple[float, float, float]:
    with torch.inference_mode():
        ess = ess_geyer_device(torch.from_numpy(samples_np).to(device)).cpu().numpy()
    return float(ess.min()), float(np.median(ess)), float(ess.max())


def result_rows(method: str, theta: np.ndarray, x: np.ndarray, accept: float, n_div: int, t: float,
                device: torch.device) -> list[str]:
    """The two table rows (hyper, latent) of one method's run."""
    s_per_sample = t / theta.shape[1]
    rows = []
    for block, samp in (("hyper", theta), ("latent", x)):
        mn, md, mx = ess_stats(samp, device)
        spm = t / mn if mn > 0 else float("inf")
        rows.append(
            f"| {method}_joint | {theta.shape[0]} | {theta.shape[1]} | {accept:.3f} | {n_div} | {block} | "
            f"({fmt(mn)}, {fmt(md)}, {fmt(mx)}) | {spm:.3g} | {t:.1f} | {s_per_sample:.3g} | "
            f"{PAPER_SECONDS_PER_SAMPLE:.1f} | {PAPER_SECONDS_PER_SAMPLE / s_per_sample:,.0f}x |")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--method", choices=("rmhmc", "mmala", "both"), default="both")
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--samples", type=int, default=5000)
    ap.add_argument("--burn-in", type=int, default=1000)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--seg", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1 or cpu")
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--calibrate", action="store_true", help="time a few sweeps and exit")
    ap.add_argument("--out", default=None, help="write the results section here (default: print it)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    has_mat = args.n == 64 and find_data_file(lgc.REFERENCE_MAT) is not None
    y, _ = lgc.load_data(n=args.n) if args.n == 64 else lgc.generate_data(seed=7, n=args.n)
    data_src = ("authors' TestData64.mat (LGC_RMHMC_Paras_LV.m:12)" if has_mat
                else f"synthetic {args.n}x{args.n} draw")
    model = interop.lgc_joint_from_numpy(y, args.n, device=device)
    init = torch.tensor([model.init_sigma_sq, model.init_beta], device=device).expand(args.chains, -1).clone()

    methods = ("rmhmc", "mmala") if args.method == "both" else (args.method,)
    rows, sanity = [], []
    for method in methods:
        cfg = (lgc_joint.LGCJointConfig(method="mmala", latent_step_size=0.07) if method == "mmala"
               else lgc_joint.LGCJointConfig())
        kernel = lgc_joint.build(model, cfg)

        if args.calibrate:
            r = parallel.run(kernel, parallel.segment_generator(args.seed, 0, device), init, num_samples=4,
                             collect=False)
            synchronize(device)
            t0 = time.perf_counter()
            r = parallel.run(kernel, parallel.segment_generator(args.seed, 1, device), None, num_samples=4,
                             collect=False, init_state=r.final_state)
            synchronize(device)
            dt = (time.perf_counter() - t0) / 4
            theta_f = r.final_state.theta.cpu().numpy()
            print(f"[calibrate {method}] {dt:.3f} s/sweep ({args.chains} chains, {device_line(device)}), "
                  f"accept={float(r.accept_rate):.3f}, finite={np.isfinite(theta_f).all()}, theta={theta_f[0]}",
                  flush=True)
            continue

        tag = f"{method}_c{args.chains}_n{args.n}_s{args.samples}"
        theta, x, accept, n_div, t = run_segmented(
            kernel, init, burn_in=args.burn_in, num_samples=args.samples, seg=args.seg, seed=args.seed,
            ckpt_dir=args.ckpt_dir, tag=tag)

        # theta holds the CONSTRAINED (sigma^2, beta) (collect_fn: st.position).
        sig, beta = theta[..., 0].ravel(), theta[..., 1].ravel()
        sanity.append(f"{method}: posterior sigma^2 = {sig.mean():.3f} +- {sig.std():.3f}, "
                      f"beta = {beta.mean():.5f} +- {beta.std():.5f} (generating values 1.91, {1 / 33:.5f})")
        print("sanity:", sanity[-1], flush=True)
        rows += result_rows(method, theta, x, accept, n_div, t, device)
        print("\n".join(rows[-2:]), flush=True)

    if args.calibrate:
        return
    section = (
        f"## LGC joint (sigma^2, beta, x) inference -- {args.n}x{args.n} grid "
        f"(D={args.n ** 2} latents + 2 hyperparameters), {device_line(device)}\n\n"
        "The paper's most expensive configuration (main_article.pdf sec. 8: \"5000 posterior\n"
        "samples taking around 90 h\"; LGC_RMHMC_Paras_LV.m:41-47 / LGC_mMALA_Paras_LV.m:42-43,\n"
        f"hyper L=1 eps=0.2 FP 3/10, latent L=20 eps=0.1 / mMALA eps=0.07); data: {data_src}.\n"
        "No per-method ESS table exists in the paper, so the speedup column compares\n"
        "wall clock per kept posterior sample against the paper's ~64.8 s/sample on its CPU;\n"
        "ESS columns are the measured chain-summed Geyer ESS (hyper = constrained\n"
        "(sigma^2, beta); latent = all field coordinates).\n\n"
        + HEADER + "\n" + "\n".join(rows) + "\n\n"
        "Hyper-posterior sanity: " + "; ".join(sanity) + "."
    )
    if args.out:
        Path(args.out).write_text(section + "\n")
        print(f"=== wrote the lgc-joint section to {args.out}", flush=True)
    else:
        print(section, flush=True)


if __name__ == "__main__":
    main()
