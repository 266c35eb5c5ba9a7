"""Operating characteristic of the taper-rotation cohort null.

``ops/cohort_null.py`` documents that sharing one rotation across
windows conditions on the observed window-to-window phase consistency:
exact under H0, but under a true coupling the null widens (no 1/W
variance shrinkage), making the test conservative.  This tool MEASURES
that conservativeness: it sweeps planted coupling strength × window
count and compares rejection rates (α = 0.05, FWE max statistic) of

  - the production taper-rotation cohort null
    (``cohort_msc_rotation_null``, shared rotation — the study-scale
    engine),
  - its ``rotation_mode='per_window'`` opt-in (independent rotation per
    disjoint window), and
  - the public full-FFT engine (``cohort_msc_fft_null``: per-surrogate
    fresh signal-level phases, ALL windows enter the inference exactly;
    feasible only at small scale because it redoes every FFT per draw).

Later additions:

  - a TWO-OFFSET disjoint arm (``power_rotation_2off``): Bonferroni
    over the even- and odd-parity disjoint subsets,
    ``p = min(1, 2·min(p_even, p_odd))`` — each parity's p is
    marginally calibrated, so the combination is valid under arbitrary
    dependence.  Measured to decide adopt-or-reject for the
    near-threshold power gap.
  - ``--h0 R`` re-measures the H0 (coupling=0) cells only, at R
    replicates per engine (default 500 — binomial 1σ at 0.05 is
    0.0097, so a true 2×-nominal defect sits >5σ out), and merges the
    result into the artifact under ``h0_highrep``.  This settles
    whether r3's W=128 rates of 0.10-0.117 at 60 replicates (2.4σ)
    were noise or a defect.

Measuring the production rotation engine where it actually runs:

  - large-W cells W ∈ {512, 1320} (single-pair, J=6; 1320 = the study's
    per-subject task-window count), at reduced replicate/surrogate
    budgets (the full-FFT arm is O(n_surrogates) cohort passes).
  - per-cell ``auto_choice`` is now evaluated at the PRODUCTION
    surrogate count (``cohort_msc_null``'s default n_surrogates=10_000)
    on this host's flop budget — the question a user of the auto entry
    point actually faces.  At 10k surrogates the cost model keeps the
    exact FFT engine for W ≤ 32 and dispatches W ≥ 128 to rotation, so
    the sweep now measures the rotation engine at cells where it is
    genuinely selected.  (Power itself is still measured at the sweep's
    reduced surrogate count — the rejection decision at α=0.05 is
    insensitive to the null's tail resolution beyond ~100 draws.)
  - a ``detection_limit`` block: per W, the interpolated coupling at
    which each engine reaches 80 % power, and their ratio — the honest
    sensitivity cost of the rotation engine in COUPLING units (the
    rejection-rate gap at a fixed near-threshold coupling looks large
    because the power curve is steep; what a user loses is a ~10-15 %
    higher detectable-coupling floor).
  - ``--extend`` runs only W values absent from the committed grid and
    merges them (the small-W cells are expensive to re-measure and the
    engines are unchanged).

Writes ``BENCH_NULL_POWER.json``; ``tests/test_null_power_artifact.py``
asserts the committed bounds (H0 calibration of both engines, and the
measured power gap staying within the documented envelope).

Run: ``JAX_PLATFORMS=cpu python tools/bench_null_power.py [--h0 500]
[--h0-only] [--extend]`` (~25 min small-W sweep; ~2 h with large W).
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

FS = 256.0
WINDOW_SEC = 0.5
J = 6
# shared-drive gain g plants true coherence ≈ g⁴/(g²+1)²: 0 → 0.25.
# per-W coupling grids straddle that W's detection threshold, where any
# power difference between the engines would surface.  Large-W cells
# (512 and the study's 1320 task windows) run fewer replicates at a
# reduced surrogate count and skip the pw/2off diagnostic arms — the
# full-FFT arm is O(n_surrogates) cohort passes (~12 s/replicate at
# W=1320 on this host).
SWEEP = {
    8:    dict(couplings=(0.0, 0.35, 0.45, 0.55, 0.7, 1.0),
               replicates=60, n_surr=200,
               arms=("rot", "pw", "2off", "fft")),
    32:   dict(couplings=(0.0, 0.35, 0.45, 0.55, 0.7, 1.0),
               replicates=60, n_surr=200,
               arms=("rot", "pw", "2off", "fft")),
    128:  dict(couplings=(0.0, 0.35, 0.45, 0.55, 0.7, 1.0),
               replicates=60, n_surr=200,
               arms=("rot", "pw", "2off", "fft")),
    512:  dict(couplings=(0.0, 0.25, 0.3, 0.35, 0.4, 0.5),
               replicates=40, n_surr=100, arms=("rot", "fft")),
    1320: dict(couplings=(0.0, 0.2, 0.25, 0.3, 0.35, 0.45),
               replicates=40, n_surr=100, arms=("rot", "fft")),
}
WINDOW_COUNTS = tuple(SWEEP)
R_REPLICATES = 60            # small-W default (kept in config block)
N_SURR = 200
ALPHA = 0.05
# the production default of cohort_msc_null — auto_choice is evaluated
# here, not at the sweep's reduced measurement budget
PRODUCTION_N_SURR = 10_000


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _make_cohort(rng, n, coupling):
    shared = rng.standard_normal(n).astype(np.float32)
    eeg = np.stack([coupling * shared[:, None]
                    + rng.standard_normal((n, 1)).astype(np.float32)
                    for _ in range(J)])
    emg = np.stack([coupling * shared[:, None]
                    + rng.standard_normal((n, 1)).astype(np.float32)
                    for _ in range(J)])
    return eeg, emg


def _cell_arms(eeg, emg, starts_np, jnp, engines, seed, n_surr=N_SURR):
    """One replicate: p_fwe for each requested engine arm."""
    from mba_tpu.ops.cohort_null import (cohort_msc_rotation_null,
                                         cohort_msc_fft_null)
    band = (8.0, 40.0)
    starts_all = np.tile(starts_np[None], (J, 1))
    kw = dict(sampling_freq=FS, n_surrogates=n_surr,
              window_length_sec=WINDOW_SEC, band=band,
              surrogate_chunk=n_surr, seed=seed,
              compute_dtype=jnp.float32)
    out = {}
    if "rot" in engines:
        out["rot"] = cohort_msc_rotation_null(
            eeg, emg, window_starts=starts_all, **kw)["p_fwe"]
    if "pw" in engines:
        out["pw"] = cohort_msc_rotation_null(
            eeg, emg, window_starts=starts_all,
            rotation_mode="per_window", **kw)["p_fwe"]
    if "2off" in engines:
        # Bonferroni over the two disjoint parities: each parity's
        # grid is non-overlapping, so each p is marginally calibrated
        # and 2·min is valid under the parities' strong dependence
        p_e = cohort_msc_rotation_null(
            eeg, emg, window_starts=np.tile(starts_np[None, 0::2],
                                            (J, 1)), **kw)["p_fwe"]
        p_o = cohort_msc_rotation_null(
            eeg, emg, window_starts=np.tile(starts_np[None, 1::2],
                                            (J, 1)), **kw)["p_fwe"]
        out["2off"] = min(1.0, 2.0 * min(p_e, p_o))
    if "fft" in engines:
        out["fft"] = cohort_msc_fft_null(
            eeg, emg, FS, n_surrogates=n_surr,
            window_length_sec=WINDOW_SEC, band=band,
            surrogate_chunk=min(50, n_surr), seed=seed,
            window_starts=starts_all)["p_fwe"]
    return out


def _auto_choice(W, n):
    """Which engine cohort_msc_null's method='auto' cost model runs for
    this data at the PRODUCTION surrogate count (its 10k default) on
    this host's CPU flop budget — the question a user of the auto entry
    point actually faces.  At 10k surrogates the exact FFT engine stays
    affordable for W <= 32; W >= 128 dispatches to rotation."""
    from mba_tpu.ops.cohort_null import _fft_null_flops
    window_samples = int(WINDOW_SEC * FS)
    nF = int((40.0 - 8.0) * WINDOW_SEC)
    est = _fft_null_flops(J, n, 1, 1, W, 5, window_samples, nF,
                          PRODUCTION_N_SURR)
    return "fft" if est <= 2e11 else "rotation"


def run_h0(R, jnp, window_counts=(8, 32, 128)):
    """H0-only cells at R replicates per engine.

    Large-W cells are excluded by default: at R=500 the full-FFT arm
    alone would cost ~35 h at W=1320; their H0 calibration is covered
    at the sweep replicate count in ``h0_rejection_rates``.
    """
    from mba_tpu.ops.framing import window_grid
    window_samples = int(WINDOW_SEC * FS)
    hop = window_samples // 2
    h0 = {}
    t_start = time.perf_counter()
    for W in window_counts:
        n = hop * (W - 1) + window_samples
        starts_np, _ = window_grid(n, window_samples, hop, FS,
                                   convention="cmc")
        starts_np = starts_np[:W]
        rej = {k: 0 for k in SWEEP[W]["arms"]}
        for r in range(R):
            rng = np.random.default_rng(777_000 + 1000 * W + r)
            eeg, emg = _make_cohort(rng, n, 0.0)
            ps = _cell_arms(eeg, emg, starts_np, jnp, rej.keys(),
                            seed=r, n_surr=SWEEP[W]["n_surr"])
            for k, p in ps.items():
                rej[k] += p < ALPHA
        h0[f"W{W}"] = {k: round(v / R, 4) for k, v in rej.items()}
        sig3 = 3.0 * float(np.sqrt(ALPHA * (1 - ALPHA) / R))
        h0[f"W{W}"]["binomial_3sigma_bound"] = round(ALPHA + sig3, 4)
        log(f"[h0 W{W}] {h0[f'W{W}']} "
            f"({time.perf_counter() - t_start:.0f}s)")
    return {"replicates": R, "alpha": ALPHA, "rates": h0}


def run_sweep(jnp, window_counts=WINDOW_COUNTS):
    from mba_tpu.ops.framing import window_grid

    window_samples = int(WINDOW_SEC * FS)
    hop = window_samples // 2

    grid = {}
    t_start = time.perf_counter()
    for W in window_counts:
        spec = SWEEP[W]
        arms, R, n_surr = spec["arms"], spec["replicates"], spec["n_surr"]
        n = hop * (W - 1) + window_samples
        starts_np, _ = window_grid(n, window_samples, hop, FS,
                                   convention="cmc")
        starts_np = starts_np[:W]
        for c in spec["couplings"]:
            rej = {k: 0 for k in arms}
            for r in range(R):
                rng = np.random.default_rng(1000 * W + int(c * 100) + r)
                eeg, emg = _make_cohort(rng, n, c)
                ps = _cell_arms(eeg, emg, starts_np, jnp, rej.keys(),
                                seed=r, n_surr=n_surr)
                for k, p in ps.items():
                    rej[k] += p < ALPHA
            key = f"W{W}_c{c:g}"
            grid[key] = {
                "windows": W, "coupling": c,
                "replicates": R, "n_surrogates": n_surr,
                "power_rotation": round(rej["rot"] / R, 3),
                "power_fullfft": round(rej["fft"] / R, 3),
                "auto_choice": _auto_choice(W, n),
            }
            if "pw" in arms:
                grid[key]["power_rotation_pw"] = round(rej["pw"] / R, 3)
            if "2off" in arms:
                grid[key]["power_rotation_2off"] = round(rej["2off"] / R,
                                                         3)
            g = grid[key]
            g["power_auto"] = (g["power_fullfft"]
                               if g["auto_choice"] == "fft"
                               else g["power_rotation"])
            log(f"[{key}] rotation {g['power_rotation']:.2f} "
                f"vs full-FFT {g['power_fullfft']:.2f} "
                f"(auto={g['auto_choice']}) "
                f"({time.perf_counter() - t_start:.0f}s)")
    return grid


def _interp_c80(cells, power_key, target=0.8):
    """Coupling at which ``power_key`` first reaches ``target``
    (linear interpolation on the cell grid; None if never reached)."""
    pts = sorted((g["coupling"], g[power_key]) for g in cells)
    for (c0, p0), (c1, p1) in zip(pts, pts[1:]):
        if p0 < target <= p1:
            if p1 == p0:
                return c1
            return round(c0 + (target - p0) * (c1 - c0) / (p1 - p0), 4)
    if pts and pts[0][1] >= target:
        return pts[0][0]
    return None


def detection_limits(grid):
    """Per-W 80 %-power coupling for each engine + their ratio — the
    rotation engine's sensitivity cost in COUPLING units (what a study
    actually loses: the minimum reliably-detectable coupling rises by
    the ratio, NOT by the headline rejection-rate gap, which is large
    only because the power curve is steep near threshold)."""
    out = {}
    for W in sorted({g["windows"] for g in grid.values()}):
        cells = [g for g in grid.values() if g["windows"] == W]
        c_rot = _interp_c80(cells, "power_rotation")
        c_fft = _interp_c80(cells, "power_fullfft")
        entry = {"c80_rotation": c_rot, "c80_fullfft": c_fft}
        if c_rot and c_fft:
            entry["coupling_cost_ratio"] = round(c_rot / c_fft, 3)
        out[f"W{W}"] = entry
    ratios = [v.get("coupling_cost_ratio") for v in out.values()
              if v.get("coupling_cost_ratio")]
    return {
        "per_window_count": out,
        "max_coupling_cost_ratio": max(ratios) if ratios else None,
        "statement": (
            "The production rotation engine's calibrated disjoint "
            "inference raises the 80%-power detectable-coupling floor "
            "by at most "
            f"{(max(ratios) - 1) * 100:.0f}% vs the exact full-FFT "
            "engine at every measured window count (8..1320); the "
            "near-threshold rejection-rate gap does not vanish with W "
            "but the coupling-units cost stays bounded."
            if ratios else "insufficient grid coverage for c80"),
    }


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    args = sys.argv[1:]
    h0_reps = 500 if ("--h0" in args or "--h0-only" in args) else 0
    if "--h0" in args:
        i = args.index("--h0")
        if i + 1 < len(args) and args[i + 1].isdigit():
            h0_reps = int(args[i + 1])

    out = REPO / "BENCH_NULL_POWER.json"
    prior = json.loads(out.read_text()) if out.exists() else {}

    if "--h0-only" in args:
        # keep the committed sweep, refresh only the H0 measurement
        result = prior
        if "grid" not in result:
            raise SystemExit("--h0-only needs an existing sweep artifact")
        result["h0_highrep"] = run_h0(h0_reps, jnp)
        result["measured_utc"] = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                               time.gmtime())
        out.write_text(json.dumps(result, indent=2) + "\n")
        log(f"[done] {out} (h0 only)")
        print(json.dumps(result["h0_highrep"]))
        return

    t_start = time.perf_counter()
    if "--extend" in args:
        # run only window counts absent from the committed grid, merge
        # (the engines are unchanged; small-W cells are expensive to
        # re-measure).  Prior cells' auto_choice is re-evaluated under
        # the current (production-10k) semantics.
        old_grid = dict(prior.get("grid", {}))
        have = {g["windows"] for g in old_grid.values()}
        todo = tuple(W for W in WINDOW_COUNTS if W not in have)
        if not todo:
            raise SystemExit("--extend: nothing to add (grid already "
                             f"covers {sorted(have)})")
        log(f"[extend] running W={todo}, keeping {sorted(have)}")
        grid = dict(old_grid)
        window_samples = int(WINDOW_SEC * FS)
        hop = window_samples // 2
        for key, g in grid.items():
            n = hop * (g["windows"] - 1) + window_samples
            g["auto_choice"] = _auto_choice(g["windows"], n)
            g["power_auto"] = (g["power_fullfft"]
                               if g["auto_choice"] == "fft"
                               else g["power_rotation"])
            g.setdefault("replicates", R_REPLICATES)
            g.setdefault("n_surrogates", N_SURR)
        grid.update(run_sweep(jnp, window_counts=todo))
    else:
        grid = run_sweep(jnp)

    # summary: worst power gap where the full-FFT engine has real power
    gaps = [g["power_fullfft"] - g["power_rotation"]
            for g in grid.values() if g["coupling"] > 0
            and g["power_fullfft"] >= 0.2]
    auto_gaps = [g["power_fullfft"] - g["power_auto"]
                 for g in grid.values() if g["coupling"] > 0
                 and g["power_fullfft"] >= 0.2]
    gaps_2off = [g["power_rotation_2off"] - g["power_rotation"]
                 for g in grid.values() if g["coupling"] > 0
                 and "power_rotation_2off" in g]
    h0_rates = {k: (g["power_rotation"], g["power_fullfft"],
                    g.get("power_rotation_pw"),
                    g.get("power_rotation_2off"))
                for k, g in grid.items() if g["coupling"] == 0}
    auto_rot_cells = sum(g["auto_choice"] == "rotation"
                         for g in grid.values())
    result = {
        "description": "rejection rate (alpha=0.05, FWE max statistic) "
                       "of the taper-rotation cohort null (shared, "
                       "per-window and two-offset-Bonferroni modes) vs "
                       "a classic full-FFT phase-randomisation cohort "
                       "null, over planted coupling x window count; "
                       "auto_choice = the engine cohort_msc_null "
                       "method='auto' runs for this data at its "
                       "PRODUCTION default n_surrogates=10k on a CPU "
                       "flop budget (power itself is measured at the "
                       "cell's reduced n_surrogates)",
        "config": {"J": J, "fs": FS, "window_sec": WINDOW_SEC,
                   "band": (8.0, 40.0), "n_surrogates": N_SURR,
                   "replicates": R_REPLICATES, "alpha": ALPHA,
                   "auto_choice_n_surrogates": PRODUCTION_N_SURR,
                   "per_window_count_overrides": {
                       str(W): {k: v for k, v in spec.items()
                                if k != "couplings"}
                       for W, spec in SWEEP.items()
                       if spec["replicates"] != R_REPLICATES}},
        "grid": grid,
        "max_power_gap_fullfft_minus_rotation": round(max(gaps), 3)
        if gaps else 0.0,
        "mean_power_gap": round(float(np.mean(gaps)), 3) if gaps else 0.0,
        "max_power_gap_fullfft_minus_auto": round(max(auto_gaps), 3)
        if auto_gaps else 0.0,
        "n_cells_auto_rotation": int(auto_rot_cells),
        "max_power_gain_2off_over_rotation": round(max(gaps_2off), 3)
        if gaps_2off else 0.0,
        "detection_limit": detection_limits(grid),
        "h0_rejection_rates": h0_rates,
        "measured_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                      time.gmtime()),
    }
    if h0_reps:
        result["h0_highrep"] = run_h0(h0_reps, jnp)
    elif "h0_highrep" in prior:
        result["h0_highrep"] = prior["h0_highrep"]
    out.write_text(json.dumps(result, indent=2) + "\n")
    log(f"[done] {out} in {time.perf_counter() - t_start:.0f}s")
    print(json.dumps({k: v for k, v in result.items() if k != "grid"}))


if __name__ == "__main__":
    main()
