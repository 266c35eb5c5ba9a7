"""Profile the extended-Infomax ICA fit at study scale.

The reference's #1 preprocessing hot spot is the MNE infomax fit
(reference preprocessing.py:654-682: 25 components over 64 ch × ~28 min
@ 2048 Hz).  The repo's fit is ONE compiled program (`lax.while_loop`
over a `lax.scan` of natural-gradient steps), so there is no dispatch
overhead to amortize — the question this tool answers is where the
remaining time goes:

  (a) serial-chain latency: the MNE block heuristic √(n/3) makes each
      epoch a chain of ~√(3n) ≈ 3,200 sequential (block×C)@(C×C)
      matmuls whose per-step cost is dominated by scan-step turnaround,
      not FLOPs; or
  (b) fundamental FLOP/bandwidth cost.

Protocol: at the study scale, fit planted 25-source mixtures at block
∈ {MNE default, 2048, 4096, 8192, 16384} and record per-epoch device
time, iterations to convergence, wall time, and source-recovery
quality (best-match |corr| of each planted source).  If epoch time
tracks the step count rather than the sample count, the fit is
latency-bound and the block cap is the right lever.

Writes ``BENCH_ICA.json``.  Run: ``python tools/profile_ica.py``
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

FS = 2048.0
MINUTES = 28.4
N_CH = 64
N_COMP = 25


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def planted_mixture(n, seed=0):
    """25 independent sources (mixed sub/super-Gaussian) in 64 channels
    + sensor noise — the ground truth for recovery scoring."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    sources = np.empty((n, N_COMP), np.float32)
    for k in range(N_COMP):
        kind = k % 3
        if kind == 0:                         # super-Gaussian (laplace)
            sources[:, k] = rng.laplace(size=n)
        elif kind == 1:                       # sub-Gaussian (square wave)
            sources[:, k] = np.sign(
                np.sin(2 * np.pi * (0.3 + 0.13 * k) * t + rng.uniform(0, 6)))
        else:                                 # sparse bursts
            s = rng.standard_normal(n) * (rng.random(n) < 0.05)
            sources[:, k] = s
    sources /= sources.std(axis=0) + 1e-12
    mixing = rng.standard_normal((N_CH, N_COMP)).astype(np.float32)
    x = sources @ mixing.T + 0.05 * rng.standard_normal(
        (n, N_CH)).astype(np.float32)
    return x.astype(np.float32), sources


def recovery_score(ica, x, true_sources, n_probe_sec=120):
    n_probe = int(n_probe_sec * FS)
    est = ica.get_sources(x[:n_probe])
    k = true_sources.shape[1]
    corr = np.abs(np.corrcoef(true_sources[:n_probe].T, est.T)[:k, k:])
    best = corr.max(axis=1)
    return float(np.median(best)), float(best.min()), \
        int(len(set(corr.argmax(axis=1))))


def main():
    import jax
    from mba_tpu.ops.ica import InfomaxICA

    platform = jax.devices()[0].platform
    n = int(MINUTES * 60 * FS)
    x, true_sources = planted_mixture(n)
    log(f"[setup] {platform}: {N_CH}ch × {MINUTES:.1f}min "
        f"({n/1e6:.2f}M samples), {N_COMP} planted sources")

    pinned = {}
    ppin = REPO / "BENCH_CPU_PINNED.json"
    if ppin.exists():
        pinned = json.loads(ppin.read_text())
    cpu_per_epoch = pinned.get("ica_cpu_sec_per_epoch_per_msample",
                               0.1006) * (n / 1e6)

    rows = []
    mne_block = int(np.floor(np.sqrt(n / 3.0)))
    for block in (mne_block, 2048, 4096, 8192, 16384):
        ica = InfomaxICA(n_components=N_COMP, max_iter=500, block=block)
        t0 = time.perf_counter()
        ica.fit(x)
        wall = time.perf_counter() - t0
        # re-run the compiled program for a pure device-time epoch rate
        # (fit wall time above includes whitening + compile)
        t0 = time.perf_counter()
        ica2 = InfomaxICA(n_components=N_COMP, max_iter=ica.n_iter_,
                          block=block)
        ica2.fit(x)
        refit = time.perf_counter() - t0
        med, worst, claimed = recovery_score(ica, x, true_sources)
        steps = n // block
        row = {
            "block": int(block),
            "steps_per_epoch": int(steps),
            "n_iter": int(ica.n_iter_),
            "fit_wall_sec_cold": round(wall, 2),
            "fit_wall_sec_warm": round(refit, 2),
            "epoch_sec_warm": round(refit / max(ica.n_iter_, 1), 4),
            "us_per_step": round(1e6 * refit / max(ica.n_iter_ * steps, 1),
                                 1),
            "recovery_median_corr": round(med, 4),
            "recovery_worst_corr": round(worst, 4),
            "recovery_claimed_unique": claimed,
            "speedup_vs_cpu_same_epochs": round(
                cpu_per_epoch * ica.n_iter_ / max(refit, 1e-9), 1),
        }
        rows.append(row)
        log(f"[block {block:>6}] {steps:>5} steps/epoch, "
            f"{ica.n_iter_} iters, warm {refit:.1f}s "
            f"({row['us_per_step']}µs/step), recovery med "
            f"{med:.3f} worst {worst:.3f}, ×{row['speedup_vs_cpu_same_epochs']} CPU")

    # default-config row (what the pipeline actually runs)
    ica_def = InfomaxICA(n_components=N_COMP, max_iter=500)
    t0 = time.perf_counter()
    ica_def.fit(x)
    wall_def = time.perf_counter() - t0
    med, worst, claimed = recovery_score(ica_def, x, true_sources)
    default_row = {
        "block": int(ica_def.block_),
        "n_iter": int(ica_def.n_iter_),
        "fit_wall_sec_cold": round(wall_def, 2),
        "recovery_median_corr": round(med, 4),
        "recovery_worst_corr": round(worst, 4),
        "speedup_vs_cpu_same_epochs": round(
            cpu_per_epoch * ica_def.n_iter_ / max(wall_def, 1e-9), 1),
    }
    log(f"[default] block={ica_def.block_}, {ica_def.n_iter_} iters, "
        f"cold {wall_def:.1f}s, recovery med {med:.3f}")

    out = {
        "description": "extended-Infomax fit at study scale (64ch × "
                       "28.4min @ 2048 Hz, 25 planted sources) vs block "
                       "size; epoch time vs serial step count separates "
                       "scan-latency-bound from FLOP-bound",
        "platform": platform,
        "n_samples": n,
        "cpu_epoch_sec_pinned": round(cpu_per_epoch, 3),
        "sweep": rows,
        "default_config": default_row,
        "measured_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    (REPO / "BENCH_ICA.json").write_text(json.dumps(out, indent=2) + "\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
