"""Bring-up smoke test of the CMC device path on one GPU.

    python3 chip_smoke.py                 # phases cmc, preprocess, cohort_null
    python3 chip_smoke.py --four-cards    # 4-card mesh path vs one card only

Drives the study's main entry points at study scale with synthetic data
made from fixed seeds, checks each result against a plain float64 numpy
reference, and prints one line per phase (sizes, compile seconds apart
from run seconds, worst error, tolerance, matmul precision).  The first
line names the card; the last line is one JSON object
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero.  The
script refuses to run without a GPU and never runs a kernel in interpret
mode.  Phase functions take their sizes as arguments, so the tests run
each at a tiny size on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np

FS = 2048.0
WINDOW_SEC = 2.0
OVERLAP = 0.5
NW = 3
BAND = (13.0, 100.0)
BETA = (16.0, 28.0)
# EMG-max cells whose two largest coherences differ by less than this are
# near-ties at float32 resolution: their CI is not compared
TIE_MARGIN = 1e-5


@dataclass(frozen=True)
class Sizes:
    """Phase sizes; ``STUDY`` is what the script runs on the card."""
    fs: float = FS
    n_eeg: int = 64
    n_emg: int = 64
    cmc_sec: float = 120.0
    cmc_grid_sec: float = 16.0
    # preprocessing: 30 × 45-s trials with 12-s silences (≈ 28 min)
    n_trials: int = 30
    n_ica: int = 25
    # cohort null
    n_subjects: int = 12
    trial_sec: float = 45.0
    silence_sec: float = 12.0
    control_sec: float = 120.0
    n_surrogates: int = 10_000
    surrogate_chunk: int = 500
    check_chunk: int = 64
    fft_null_surrogates: int = 32


STUDY = Sizes()


class CompileMeter:
    """Seconds JAX spends tracing, lowering and compiling (all phases)."""

    def __init__(self):
        import jax
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._cb)

    def _cb(self, event, dur, **_kw):
        if event.startswith("/jax/core/compile/"):
            self.total += dur


def _timed(meter: CompileMeter, fn):
    """Run ``fn`` twice: (result, compile seconds, warm run seconds)."""
    import jax
    c0 = meter.total
    jax.block_until_ready(fn())
    compile_sec = meter.total - c0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, compile_sec, time.perf_counter() - t0


def _check(name: str, err: float, tol: float):
    if not err <= tol:
        raise AssertionError(f"{name}: worst error {err:.3e} > {tol:.1e}")


# ── references (float64 numpy) ─────────────────────────────────────────
def _fisher(c):
    c = np.clip(c, 1e-10, 1 - 1e-10)
    return 0.5 * np.log((1 + c) / (1 - c))


def reference_msc_window(ew, mw, tapers, t_crit):
    """Jackknifed multitaper MSC of one window, float64.

    ew: (S, E), mw: (S, M).  Returns (coherence, ci_lower, ci_upper),
    each (F, E, M): leave-one-out replicates over the tapers, mean in
    coherence space, variance in Fisher-z space, Student-t CI clamped to
    contain the mean (reference signal_features.py:484-578, 619-839).
    """
    ew = ew.astype(np.float64)
    mw = mw.astype(np.float64)
    K = len(tapers)
    E = np.fft.rfft(ew[None] * tapers[:, :, None], axis=1)   # (K, F, E)
    M = np.fft.rfft(mw[None] * tapers[:, :, None], axis=1)   # (K, F, M)
    pe_k = np.abs(E) ** 2
    pm_k = np.abs(M) ** 2
    sum_c = np.einsum("kfe,kfm->fem", np.conj(E), M)
    sum_e, sum_m = pe_k.sum(0), pm_k.sum(0)
    reps = []
    for k in range(K):
        c = sum_c - np.conj(E[k])[:, :, None] * M[k][:, None, :]
        pe = sum_e - pe_k[k]
        pm = sum_m - pm_k[k]
        den = np.maximum(pe[:, :, None] * pm[:, None, :],
                         np.finfo(np.float64).tiny)
        reps.append(np.clip(np.abs(c) ** 2 / den, 0, 1))
    reps = np.stack(reps)
    cmean = np.clip(reps.mean(0), 0, 1)
    z = _fisher(reps)
    zv = (K - 1) / K * ((z - z.mean(0)) ** 2).sum(0)
    zc = _fisher(cmean)
    lo = np.minimum(np.tanh(zc - t_crit * np.sqrt(zv)) ** 2, cmean)
    hi = np.maximum(np.tanh(zc + t_crit * np.sqrt(zv)) ** 2, cmean)
    return cmean, lo, hi


def reference_emg_max(coh, lo, hi):
    """CI-aligned max over the EMG axis (first index of the max), plus
    the margin between the two largest coherences: where it is below
    float32 round-off, which channel's CI is taken is not defined."""
    idx = np.argmax(coh, axis=-1)[..., None]
    take = lambda a: np.take_along_axis(a, idx, axis=-1)[..., 0]
    top2 = np.sort(coh, axis=-1)[..., -2:] if coh.shape[-1] > 1 else None
    margin = (top2[..., 1] - top2[..., 0] if top2 is not None
              else np.full(coh.shape[:-1], np.inf))
    return take(coh), take(lo), take(hi), margin


def _beta_drive(n: int, fs: float, rng) -> np.ndarray:
    """Unit-variance stochastic drive confined to 15–30 Hz."""
    f = np.fft.rfftfreq(n, 1 / fs)
    sel = (f >= 15) & (f <= 30)
    spec = np.zeros(len(f), np.complex64)
    spec[sel] = np.exp(1j * rng.uniform(0, 2 * np.pi, int(sel.sum())))
    drive = np.fft.irfft(spec, n=n).astype(np.float32)
    return drive / (drive.std() + 1e-12)


# ── phase: cmc ─────────────────────────────────────────────────────────
def phase_cmc(platform: str, meter: CompileMeter, sz: Sizes = STUDY):
    """``ops.coherence.multitaper_msc`` at the bench's flagship shape,
    jackknife + EMG max, then the full-grid mode on the first 16 s."""
    from scipy.stats import t as t_dist
    from mba_tpu.ops.coherence import multitaper_msc
    from mba_tpu.ops.dpss import filtered_tapers

    rng = np.random.default_rng(0)
    n = int(sz.fs * sz.cmc_sec)
    shared = _beta_drive(n, sz.fs, rng)
    eeg = (0.4 * shared[:, None]
           + rng.standard_normal((n, sz.n_eeg), np.float32))
    emg = (0.4 * shared[:, None]
           + rng.standard_normal((n, sz.n_emg), np.float32))
    kw = dict(sampling_freq=sz.fs, nw=NW, window_length_sec=WINDOW_SEC,
              overlap_frac=OVERLAP, use_jackknife=True,
              apply_independence_threshold=False)

    res, c_sec, r_sec = _timed(meter, lambda: multitaper_msc(
        eeg, emg, aggregate_emg_max=True, **kw))
    ws = int(WINDOW_SEC * sz.fs)
    hop = int(ws * (1 - OVERLAP))
    tapers = np.asarray(filtered_tapers(ws, NW, 0.9), np.float64)
    K = len(tapers)
    t_crit = t_dist.ppf(0.975, K - 1)
    W = res["coherence_raw"].shape[0]
    err = {"coherence": 0.0, "ci": 0.0}
    near_ties = 0
    for w in sorted({0, W // 2, W - 1}):
        s = w * hop
        c, lo, hi, margin = reference_emg_max(*reference_msc_window(
            eeg[s:s + ws], emg[s:s + ws], tapers, t_crit))
        err["coherence"] = max(err["coherence"], float(np.abs(
            res["coherence_raw"][w] - c).max()))
        # CIs of cells whose top two EMG coherences are within f32
        # round-off of each other may come from either channel
        ok = margin > TIE_MARGIN
        near_ties += int((~ok).sum())
        err["ci"] = max(err["ci"], float(max(
            np.abs(res["coherence_ci_lower"][w] - lo)[ok].max(),
            np.abs(res["coherence_ci_upper"][w] - hi)[ok].max())))
    _check("cmc coherence", err["coherence"], 1e-4)
    _check("cmc ci", err["ci"], 1e-3)

    n16 = int(sz.fs * sz.cmc_grid_sec)
    grid, g_c_sec, g_r_sec = _timed(meter, lambda: multitaper_msc(
        eeg[:n16], emg[:n16], aggregate_emg_max=False, **kw))
    Wg = grid["coherence_raw"].shape[0]
    g_err = {"coherence": 0.0, "ci": 0.0}
    for w in sorted({0, Wg // 2, Wg - 1}):
        s = w * hop
        ref = reference_msc_window(eeg[s:s + ws], emg[s:s + ws], tapers,
                                   t_crit)
        g_err["coherence"] = max(g_err["coherence"], float(np.abs(
            grid["coherence_raw"][w] - ref[0]).max()))
        g_err["ci"] = max(g_err["ci"], float(max(
            np.abs(grid["coherence_ci_lower"][w] - ref[1]).max(),
            np.abs(grid["coherence_ci_upper"][w] - ref[2]).max())))
    _check("cmc full-grid coherence", g_err["coherence"], 1e-4)
    _check("cmc full-grid ci", g_err["ci"], 1e-3)
    return {
        "phase": "cmc", "platform": platform,
        "epilogue": "xla",
        "sizes": {"eeg": sz.n_eeg, "emg": sz.n_emg, "fs": sz.fs,
                  "seconds": sz.cmc_sec, "windows": W, "K": K,
                  "freqs": int(res["freqs"].shape[0]),
                  "grid_seconds": sz.cmc_grid_sec, "grid_windows": Wg},
        "compile_sec": round(c_sec, 3), "run_sec": round(r_sec, 4),
        "grid_compile_sec": round(g_c_sec, 3),
        "grid_run_sec": round(g_r_sec, 4),
        "max_abs_err": err, "grid_max_abs_err": g_err,
        "ci_cells_skipped_as_emg_near_ties": near_ties,
        "tolerance": {"coherence": 1e-4, "ci": 1e-3},
        "reference": "float64 numpy taper loop, windows first/mid/last",
        "matmul_precision": "none on this path (FFT + elementwise)",
    }


# ── phase: preprocess ──────────────────────────────────────────────────
def phase_preprocess(platform: str, meter: CompileMeter,
                     sz: Sizes = STUDY):
    """``pipeline.preprocessing.BiosignalPreprocessor`` on one subject's
    64-ch EEG at the study's length (band-pass, notch, average reference,
    amplitude rejection, 25-component ICA, Laplacian, wavelet
    denoising), then gate G1 of tools/bench_pipeline.py: the planted
    16–28 Hz coupling with a planted EMG channel stays above the
    Beta(K−2, K−2) independence threshold."""
    import jax
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import synth_study as S
    from mba_tpu.ops.coherence import (cmc_independence_threshold,
                                       multitaper_msc)
    from mba_tpu.pipeline.preprocessing import BiosignalPreprocessor

    fs = S.FS                        # the synthesized study's rate
    plan = S.TrialPlan(n_trials=sz.n_trials)
    eeg, emg1, _ = S.synth_subject(plan)
    eeg, emg1 = eeg[:, :sz.n_eeg], emg1[:, :1]

    def cascade():
        prep = BiosignalPreprocessor(
            jax.device_put(eeg), int(fs), "eeg",
            n_ica_components=sz.n_ica, automatic_ic_labelling=True,
            wavelet_type="db4", amplitude_rejection_threshold=3.0,
            device_resident=True)
        return prep.np_output_data, prep

    (clean, prep), c_sec, r_sec = _timed(meter, cascade)
    clean = np.asarray(clean)
    finite = bool(np.isfinite(clean).all())
    if not finite:
        raise AssertionError("preprocess: non-finite output")

    # G1 on the music-trial task windows (window centres inside a span)
    ws = int(WINDOW_SEC * fs)
    hop = int(ws * (1 - OVERLAP))
    n_win = (clean.shape[0] - ws) // hop + 1
    centres = (np.arange(n_win) * hop + ws / 2) / fs
    mask = np.zeros(n_win, bool)
    for t_s, t_e in plan.signal_relative_spans("music"):
        mask |= (centres >= t_s + WINDOW_SEC / 2) \
            & (centres <= t_e - WINDOW_SEC / 2)
    res = multitaper_msc(clean, emg1, fs, nw=NW,
                         window_length_sec=WINDOW_SEC, overlap_frac=OVERLAP,
                         use_jackknife=False, window_mask=mask,
                         apply_independence_threshold=False,
                         freq_range=BETA)
    peak = res["coherence_raw"][mask].max(axis=1)       # (W, E, 1)
    music_cmc = float(peak.reshape(peak.shape[0], -1).mean(axis=1).mean())
    K = res["metadata"]["K_tapers"]
    thresh = float(cmc_independence_threshold(K))
    if not music_cmc > thresh:
        raise AssertionError(
            f"preprocess G1: music beta CMC {music_cmc:.4f} <= "
            f"Beta(K-2,K-2) threshold {thresh:.4f}")
    return {
        "phase": "preprocess", "platform": platform,
        "sizes": {"eeg": int(eeg.shape[1]), "samples": int(eeg.shape[0]),
                  "minutes": round(eeg.shape[0] / fs / 60, 2),
                  "bytes_f32": int(eeg.nbytes), "ica_components": sz.n_ica,
                  "music_windows": int(mask.sum())},
        "compile_sec": round(c_sec, 3), "run_sec": round(r_sec, 3),
        "ica_excluded": len(prep.ica_result.exclude),
        "finite": finite,
        "g1_music_beta_cmc": round(music_cmc, 4),
        "g1_threshold": round(thresh, 4),
        "reference": "gate G1 (Beta(K-2,K-2) threshold), finite output",
        "matmul_precision": "JAX default (ICA, Laplacian)",
    }


# ── phase: cohort_null ─────────────────────────────────────────────────
def _study_cohort(sz: Sizes, seed: int):
    """Study-scale int8 ADC-count cohort made on the device (uniform
    channel noise + a quantized beta-band shared drive, bench.py's
    generator), with the per-subject task-window grid."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    trial_hop = sz.trial_sec + sz.silence_sec
    n = int(sz.fs * (sz.n_trials * trial_hop - sz.silence_sec))
    ws = int(WINDOW_SEC * sz.fs)
    hop = int(ws * (1 - OVERLAP))
    starts_1 = np.concatenate([
        int(i * trial_hop * sz.fs)
        + np.arange(0, int(sz.trial_sec * sz.fs) - ws + 1, hop)
        for i in range(sz.n_trials)]).astype(np.int64)
    starts = np.tile(starts_1[None], (sz.n_subjects, 1))
    drive = np.clip(np.rint(16.0 * _beta_drive(n, sz.fs, rng)), -38,
                    38).astype(np.int8)
    drive_d = jnp.asarray(drive)

    @jax.jit
    def counts(key):
        bits = jax.random.bits(key, (n, sz.n_eeg), jnp.uint8)
        return ((bits & 127).astype(jnp.int8) - 64) + drive_d[:, None]

    keys = jax.random.split(jax.random.PRNGKey(seed), 2 * sz.n_subjects)
    eeg = jnp.stack([counts(k) for k in keys[:sz.n_subjects]])
    emg = jnp.stack([counts(k) for k in keys[sz.n_subjects:]])
    return eeg, emg, starts


def _control_cohort(sz: Sizes, seed: int):
    """Uncoupled float32 control: independent noise, 120 s per subject."""
    rng = np.random.default_rng(seed)
    n = int(sz.fs * sz.control_sec)
    eeg = rng.standard_normal((sz.n_subjects, n, sz.n_eeg), np.float32)
    emg = rng.standard_normal((sz.n_subjects, n, sz.n_emg), np.float32)
    return eeg, emg


def reference_null_chunk(key, coef_all, base_flat, observed_flat,
                         n_chunk: int, K: int):
    """One surrogate chunk in float64: ``base + G·coef/J`` with the
    rotation phases drawn from ``key`` as the engine draws them.
    Returns (max_stat (S,), exceedance counts (F, N))."""
    import jax
    from mba_tpu.ops.cohort_null import _pair_indices
    J, nF, nN, P = coef_all.shape
    phi = np.asarray(jax.random.uniform(key, (J, n_chunk, K, nF),
                                        minval=0.0, maxval=2.0 * np.pi),
                     np.float64)
    ks, ls = _pair_indices(K)
    d = phi[:, :, ks, :] - phi[:, :, ls, :]                # (J, S, P/2, F)
    G = np.concatenate([np.cos(d), np.sin(d)], axis=2)    # (J, S, P, F)
    Gf = np.transpose(G, (3, 1, 0, 2)).reshape(nF, n_chunk, J * P)
    Cf = np.transpose(np.asarray(coef_all, np.float64),
                      (1, 0, 3, 2)).reshape(nF, J * P, nN)
    stat = np.asarray(base_flat, np.float64)[:, None, :] \
        + np.matmul(Gf, Cf) / J                            # (F, S, N)
    obs = np.asarray(observed_flat, np.float64)
    return stat.max(axis=(0, 2)), (stat >= obs[:, None, :]).sum(axis=1)


def phase_cohort_null(platform: str, meter: CompileMeter,
                      sz: Sizes = STUDY):
    """``ops.cohort_null.cohort_msc_null(method="rotation")`` at study
    scale: planted coupling gives p_fwe < 0.01, an uncoupled 120-s
    control gives p_fwe > 0.05; one 64-surrogate chunk against a float64
    recomputation; the observed map against ``multitaper_msc`` on two
    subjects; the full-FFT engine's achieved FLOP/s."""
    import jax
    import jax.numpy as jnp
    from mba_tpu.ops import cohort_null as CN
    from mba_tpu.ops import gram_coeffs
    from mba_tpu.ops.coherence import multitaper_msc
    from mba_tpu.ops.dpss import filtered_tapers

    eeg, emg, starts = _study_cohort(sz, seed=23)
    eeg_samples, eeg_bytes, emg_bytes = eeg.shape[1], eeg.nbytes, emg.nbytes
    weights = np.ones(starts.shape, np.float32)
    kw = dict(nw=NW, window_length_sec=WINDOW_SEC, overlap_frac=OVERLAP,
              band=BAND, window_starts=starts, window_weights=weights)
    null_kw = dict(kw, surrogate_chunk=sz.surrogate_chunk,
                   overlap_upload=False)
    res, c_sec, r_sec = _timed(meter, lambda: CN.cohort_msc_null(
        eeg, emg, sz.fs, n_surrogates=sz.n_surrogates, method="rotation",
        **null_kw))
    if not res["p_fwe"] < 0.01:
        raise AssertionError(f"cohort_null: planted p_fwe {res['p_fwe']}")

    # one chunk from seed 0, against float64 on the same coefficients
    ws = int(WINDOW_SEC * sz.fs)
    tapers = jnp.asarray(filtered_tapers(ws, NW, 0.9), jnp.float32)
    K = int(tapers.shape[0])
    lo, hi = res["metadata"]["band_bins"]
    wts = CN.disjoint_window_weights(starts, weights, ws)
    base_c, coef_all, observed_flat = CN._cohort_rotation_coeffs(
        eeg, emg, jnp.asarray(starts, jnp.int32), jnp.asarray(wts), tapers,
        ws, lo, hi, 32, use_gram=True)
    chunk = CN.cohort_msc_rotation_null(
        eeg, emg, sz.fs, n_surrogates=sz.check_chunk,
        surrogate_chunk=sz.check_chunk, seed=0, overlap_upload=False, **kw)
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    nF = hi - lo
    ms_ref, counts_ref = reference_null_chunk(
        sub, coef_all, base_c.reshape(nF, -1), observed_flat,
        sz.check_chunk, K)
    ms_err = float(np.abs(chunk["max_stat"] - ms_ref).max()
                   / np.abs(ms_ref).max())
    counts_dev = np.rint(chunk["p_uncorrected"] * (1 + sz.check_chunk)
                         - 1).reshape(counts_ref.shape)
    counts_err = float(abs(counts_dev.sum() - counts_ref.sum())
                       / max(counts_ref.sum(), 1))
    _check("cohort_null chunk max_stat (relative)", ms_err, 1e-4)
    _check("cohort_null chunk counts (relative)", counts_err, 1e-4)

    # observed map vs multitaper_msc's window mean, two-subject cohort
    two = CN.cohort_msc_rotation_null(
        eeg[:2], emg[:2], sz.fs, precompute_only=True, overlap_upload=False,
        **dict(kw, window_starts=starts[:2], window_weights=weights[:2]))
    hop = int(ws * (1 - OVERLAP))
    maps = []
    for j in range(2):
        n_win = (eeg.shape[1] - ws) // hop + 1
        kept = set(starts[j][wts[j] > 0].tolist())
        mask = np.isin(np.arange(n_win) * hop, list(kept))
        r = multitaper_msc(eeg[j], emg[j], sz.fs, nw=NW,
                           window_length_sec=WINDOW_SEC,
                           overlap_frac=OVERLAP, use_jackknife=False,
                           window_mask=mask, freq_range=BAND,
                           apply_independence_threshold=False)
        assert r["freqs"].shape[0] == nF
        maps.append(r["coherence_raw"][mask].mean(axis=0))
    obs_err = float(np.abs(two["observed"] - np.mean(maps, axis=0)).max())
    _check("cohort_null observed map", obs_err, 1e-4)
    del eeg, emg, coef_all

    # uncoupled 12 × 120-s control; the full-FFT engine's achieved rate
    ce, cm = _control_cohort(sz, seed=5)
    ctl = CN.cohort_msc_null(ce, cm, sz.fs, n_surrogates=sz.n_surrogates,
                             method="rotation", nw=NW,
                             window_length_sec=WINDOW_SEC,
                             overlap_frac=OVERLAP, band=BAND,
                             surrogate_chunk=sz.surrogate_chunk)
    if not ctl["p_fwe"] > 0.05:
        raise AssertionError(f"cohort_null: control p_fwe {ctl['p_fwe']}")
    fft_kw = dict(nw=NW, window_length_sec=WINDOW_SEC, overlap_frac=OVERLAP,
                  band=BAND, surrogate_chunk=8)
    fft_run = lambda: CN.cohort_msc_fft_null(
        ce, cm, sz.fs, n_surrogates=sz.fft_null_surrogates, **fft_kw)
    fft_res, f_c_sec, _ = _timed(meter, fft_run)
    f_sec = fft_res["metadata"]["timings"]["null_sec"]
    J, n_ctl = ce.shape[:2]
    W_ctl = (n_ctl - ws) // hop + 1
    fft_flops = CN._fft_null_flops(J, n_ctl, sz.n_eeg, sz.n_emg, W_ctl, K,
                                   ws, nF, sz.fft_null_surrogates)
    rate = fft_flops / f_sec
    budget = rate * 60.0
    n_study = int(eeg_samples)
    study_est = CN._fft_null_flops(J, n_study, sz.n_eeg, sz.n_emg,
                                   int(starts.shape[1]), K, ws, nF,
                                   sz.n_surrogates)
    return {
        "phase": "cohort_null", "platform": platform,
        "sizes": {"subjects": sz.n_subjects,
                  "task_windows_per_subject": int(starts.shape[1]),
                  "cohort_bytes_int8": int(eeg_bytes + emg_bytes),
                  "band_bins": int(nF), "surrogates": sz.n_surrogates,
                  "chunk": sz.surrogate_chunk},
        "compile_sec": round(c_sec, 3), "run_sec": round(r_sec, 3),
        "stage_sec": res["metadata"]["timings"],
        "p_fwe_planted": res["p_fwe"], "p_fwe_control": ctl["p_fwe"],
        "chunk_max_stat_rel_err": ms_err,
        "chunk_counts_rel_err": counts_err,
        "chunk_cells_differing": int((counts_dev != counts_ref).sum()),
        "observed_map_max_abs_err": obs_err,
        "tolerance": {"chunk_rel": 1e-4, "observed_abs": 1e-4},
        "fft_null": {"surrogates": sz.fft_null_surrogates,
                     "compile_sec": round(f_c_sec, 3),
                     "null_sec": f_sec, "flops": fft_flops,
                     "flop_per_sec": rate, "budget_60s": budget,
                     "study_scale_flops": study_est,
                     "study_scale_auto_choice":
                         "fft" if study_est <= budget else "rotation"},
        "reference": "float64 numpy base+G.coef/J (same key); "
                     "multitaper_msc window mean on 2 subjects",
        "matmul_precision": {
            "gram_dft": str(gram_coeffs.DFT_PRECISION),
            "gram_pairs": str(gram_coeffs.GRAM_PRECISION),
            "null_contraction": str(CN.NULL_PRECISION)},
    }


# ── --four-cards ───────────────────────────────────────────────────────
def phase_four_cards(platform: str, meter: CompileMeter, sz: Sizes = STUDY,
                     n_dev: int = 4):
    """The mesh path on ``n_dev`` devices against the same inputs on one:
    cohort CMC (subjects × windows mesh), time-sharded CMC of one
    recording, and the rotation null with its sharded coefficient pass."""
    import jax
    import jax.numpy as jnp
    from mba_tpu.ops import cohort_null as CN
    from mba_tpu.ops.dpss import filtered_tapers
    from mba_tpu.parallel import (cohort_multitaper_msc, make_mesh,
                                  time_sharded_msc)

    if len(jax.devices()) < n_dev:
        raise RuntimeError(f"--four-cards needs {n_dev} devices, "
                           f"found {len(jax.devices())}")
    rng = np.random.default_rng(9)
    n = int(sz.fs * sz.control_sec)
    shared = _beta_drive(n, sz.fs, rng)
    eeg = np.stack([0.25 * shared[:, None] + rng.standard_normal(
        (n, sz.n_eeg), np.float32) for _ in range(sz.n_subjects)])
    emg = np.stack([0.25 * shared[:, None] + rng.standard_normal(
        (n, sz.n_emg), np.float32) for _ in range(sz.n_subjects)])
    mesh4, mesh1 = make_mesh(n_dev), make_mesh(1)
    cmc_kw = dict(nw=NW, window_length_sec=WINDOW_SEC, overlap_frac=OVERLAP,
                  use_jackknife=True, aggregate_emg_max=True)

    many, c4, r4 = _timed(meter, lambda: cohort_multitaper_msc(
        mesh4, eeg, emg, sz.fs, **cmc_kw))
    one, c1, r1 = _timed(meter, lambda: cohort_multitaper_msc(
        mesh1, eeg, emg, sz.fs, **cmc_kw))
    cmc_err = max(float(np.abs(many[k] - one[k]).max())
                  for k in ("coherence_raw", "coherence_ci_lower",
                            "coherence_ci_upper"))
    _check("four-cards cohort CMC", cmc_err, 1e-5)

    ts = time_sharded_msc(mesh4, eeg[0], emg[0], sz.fs, **cmc_kw)
    ts_err = float(np.abs(ts["coherence_raw"]
                          - one["coherence_raw"][0]).max())
    _check("four-cards time-sharded CMC", ts_err, 1e-5)

    null_kw = dict(nw=NW, window_length_sec=WINDOW_SEC,
                   overlap_frac=OVERLAP, band=BAND,
                   n_surrogates=sz.n_surrogates,
                   surrogate_chunk=sz.surrogate_chunk // n_dev, seed=3)
    null4, nc4, nr4 = _timed(meter, lambda: CN.cohort_msc_rotation_null(
        eeg, emg, sz.fs, mesh=mesh4, **null_kw))
    # one card, same key stream: each mesh chunk draws device d's
    # surrogates from split(sub, n_dev)[d]
    ws = int(WINDOW_SEC * sz.fs)
    hop = int(ws * (1 - OVERLAP))
    starts = np.tile(np.arange(0, n - ws + 1, hop)[None],
                     (sz.n_subjects, 1))
    wts = CN.disjoint_window_weights(
        starts, np.ones(starts.shape, np.float32), ws)
    tapers = jnp.asarray(filtered_tapers(ws, NW, 0.9), jnp.float32)
    K = int(tapers.shape[0])
    lo, hi = null4["metadata"]["band_bins"]
    t0 = time.perf_counter()
    base_c, coef_all, obs_flat = CN._cohort_rotation_coeffs(
        jnp.asarray(eeg), jnp.asarray(emg), jnp.asarray(starts, jnp.int32),
        jnp.asarray(wts), tapers, ws, lo, hi, 32, use_gram=True)
    base_flat = base_c.reshape(hi - lo, -1)
    counts = jnp.zeros(base_flat.shape, jnp.int32)
    key, max_stats, drawn = jax.random.PRNGKey(3), [], 0
    chunk = sz.surrogate_chunk // n_dev
    while drawn < sz.n_surrogates:
        key, sub = jax.random.split(key)
        for kd in jax.random.split(sub, n_dev):
            ms, counts = CN._null_chunk_jit(kd, coef_all, base_flat,
                                            obs_flat, counts, chunk, K,
                                            jnp.float32)
            max_stats.append(np.asarray(ms))
        drawn += n_dev * chunk
    one_null_sec = time.perf_counter() - t0
    ms1 = np.concatenate(max_stats)[:sz.n_surrogates]
    obs = np.asarray(obs_flat)
    p1 = float((1.0 + (ms1 >= obs.max()).sum()) / (1.0 + len(ms1)))
    ms_err = float(np.abs(null4["max_stat"] - ms1).max())
    _check("four-cards null max_stat", ms_err, 1e-5)
    if null4["p_fwe"] != p1:
        raise AssertionError(f"four-cards p_fwe {null4['p_fwe']} != {p1}")
    peaks = [int(d.memory_stats().get("peak_bytes_in_use", 0))
             if d.memory_stats() else None for d in jax.devices()[:n_dev]]
    return {
        "phase": "four_cards", "platform": platform, "devices": n_dev,
        "sizes": {"subjects": sz.n_subjects, "seconds": sz.control_sec,
                  "eeg": sz.n_eeg, "emg": sz.n_emg,
                  "surrogates": sz.n_surrogates},
        "mesh": dict(mesh4.shape),
        "cmc_compile_sec": {"four": round(c4, 3), "one": round(c1, 3)},
        "cmc_run_sec": {"four": round(r4, 4), "one": round(r1, 4)},
        "null_compile_sec": round(nc4, 3),
        "null_run_sec": {"four": round(nr4, 3),
                         "one_incl_compile": round(one_null_sec, 3)},
        "null_stage_sec_four": null4["metadata"]["timings"],
        "cmc_max_abs_diff": cmc_err, "time_sharded_max_abs_diff": ts_err,
        "null_max_stat_max_abs_diff": ms_err,
        "p_fwe": {"four": null4["p_fwe"], "one": p1},
        "peak_bytes_per_device": peaks,
        "tolerance": {"coherence": 1e-5, "max_stat": 1e-5,
                      "p_fwe": "equal"},
        "matmul_precision": {"null_contraction": str(CN.NULL_PRECISION)},
    }


# ── driver ─────────────────────────────────────────────────────────────
def card_line() -> str:
    """``name, power.limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


PHASES = {"cmc": phase_cmc, "preprocess": phase_preprocess,
          "cohort_null": phase_cohort_null}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh path and its 1-card "
                         "comparison")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of the one-card phases")
    args = ap.parse_args(argv)

    import jax
    import mba_tpu  # noqa: F401  (fails outside a checkout of the repo)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    print(f"{card_line()} | device_kind: {dev.device_kind} | "
          f"jax {jax.__version__}", flush=True)
    meter = CompileMeter()
    if args.four_cards:
        runs = [lambda: phase_four_cards(dev.platform, meter)]
    else:
        runs = [lambda f=PHASES[p]: f(dev.platform, meter)
                for p in args.phases.split(",")]
    for run in runs:
        t0 = time.perf_counter()
        rec = run()
        rec["phase_wall_sec"] = round(time.perf_counter() - t0, 3)
        print(json.dumps(rec, default=str), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
