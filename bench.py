"""Benchmark: CMC spectra/sec per device (primary) + 10k-surrogate null wall.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

- Workload (north star, BASELINE.json): 64-ch EEG × 64-ch HD-EMG multitaper
  CMC with leave-one-out jackknife CIs, 2-s windows, 50 % overlap @ 2048 Hz.
  One "spectrum" = one EEG×EMG pair's coherence spectrum in one window, so
  rate = n_windows × 64 × 64 / elapsed.
- vs_baseline: same algorithm measured in numpy on this host's CPU, written
  exactly the way the reference computes it (per-window taper loop +
  K×(K−1) jackknife re-accumulation, signal_features.py:619-839/484-578),
  extrapolated from a few windows.

Secondary (stderr): 10 000 phase-randomised surrogate MSC nulls for a
single EEG×EMG pair (BASELINE.json config 4).

The first stderr line names the card and its power limit.  Any failed
phase makes the script exit non-zero after the final line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

_PINNED_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "BENCH_CPU_PINNED.json")


def pinned_cpu() -> dict:
    """Committed CPU denominators (median-of-5 on the CI host) so
    ``vs_baseline`` is not re-derived from a noisy 2-window sample each
    run.  The live CPU measurement is still taken and logged for drift
    visibility."""
    try:
        with open(_PINNED_PATH) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}

FS = 2048.0
SECONDS = 120.0
WINDOW_SEC = 2.0
OVERLAP = 0.5
N_EEG = 64
N_EMG = 64
NW = 3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_signals(seed=0):
    rng = np.random.default_rng(seed)
    n = int(FS * SECONDS)
    t = np.arange(n) / FS
    # band-limited shared stochastic drive (realistic beta-band CMC)
    white = rng.standard_normal(n)
    spec = np.fft.rfft(white)
    f = np.fft.rfftfreq(n, 1 / FS)
    spec[(f < 15) | (f > 30)] = 0
    shared = np.fft.irfft(spec, n=n)
    shared /= shared.std() + 1e-12
    eeg = (0.4 * shared[:, None]
           + rng.standard_normal((n, N_EEG))).astype(np.float32)
    emg = (0.4 * shared[:, None]
           + rng.standard_normal((n, N_EMG))).astype(np.float32)
    return eeg, emg


def cpu_reference_rate(eeg, emg, n_windows_to_time=2):
    """Reference-style numpy CMC (taper loop + K×(K−1) jackknife)."""
    import scipy.signal
    from scipy.stats import t as t_dist

    ws = int(WINDOW_SEC * FS)
    hop = int(ws * (1 - OVERLAP))
    k = int(2 * NW - 1)
    tapers, ratios = scipy.signal.windows.dpss(M=ws, NW=NW, Kmax=k,
                                               return_ratios=True)
    tapers = tapers[ratios > 0.9]
    tapers /= np.sqrt((tapers ** 2).sum(axis=1, keepdims=True))
    K = len(tapers)
    scale = 1.0 / (FS * ws)
    n_freqs = ws // 2 + 1

    times = []
    for _rep in range(3):        # median-of-3: host speed varies ~4x
        t0 = time.perf_counter()
        _cpu_reference_pass(eeg, emg, tapers, n_windows_to_time, hop,
                            ws, K, scale, n_freqs)
        times.append(time.perf_counter() - t0)
    elapsed = float(np.median(times))
    rate = n_windows_to_time * N_EEG * N_EMG / elapsed
    return rate, elapsed


def _cpu_reference_pass(eeg, emg, tapers, n_windows_to_time, hop, ws, K,
                        scale, n_freqs):
    for w in range(n_windows_to_time):
        s = w * hop
        ew = eeg[s:s + ws]
        mw = emg[s:s + ws]
        psd_e_sum = np.zeros((n_freqs, N_EEG))
        psd_m_sum = np.zeros((n_freqs, N_EMG))
        csd_sum = np.zeros((n_freqs, N_EEG, N_EMG), dtype=np.complex128)
        for taper in tapers:  # main accumulation (reference style)
            ef = np.fft.rfft(ew * taper[:, None], axis=0)
            mf = np.fft.rfft(mw * taper[:, None], axis=0)
            psd_e_sum += np.abs(ef) ** 2 * scale
            psd_m_sum += np.abs(mf) ** 2 * scale
            csd_sum += np.conj(ef)[:, :, None] * mf[:, None, :] * scale
        # jackknife: leave-one-out re-accumulation over K × (K−1) tapers
        for leave_out in range(K):
            pe = np.zeros((n_freqs, N_EEG), np.float32)
            pm = np.zeros((n_freqs, N_EMG), np.float32)
            cs = np.zeros((n_freqs, N_EEG, N_EMG), np.complex64)
            for j, taper in enumerate(tapers):
                if j == leave_out:
                    continue
                ef = np.fft.rfft(ew * taper[:, None], axis=0)
                mf = np.fft.rfft(mw * taper[:, None], axis=0)
                pe += np.abs(ef) ** 2 * scale
                pm += np.abs(mf) ** 2 * scale
                cs += np.conj(ef)[:, :, None] * mf[:, None, :] * scale
            num = np.abs(cs / (K - 1)) ** 2
            den = np.maximum((pe / (K - 1))[:, :, None]
                             * (pm / (K - 1))[:, None, :], 1e-300)
            _ = np.clip(num / den, 0, 1)
    # CI arithmetic negligible vs the loops above


def card_name() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unknown ({type(exc).__name__})"


def device_rate(eeg, emg):
    from mba_tpu.ops.coherence import multitaper_msc

    # coherence/CI values live in [0, 1] so the int8 result transfer with
    # adaptive per-(freq, eeg) lanes (measured error ≤ ~2e-3 absolute
    # coherence — ~0.5 % of a typical jackknife CI width; see
    # multitaper_msc / download_quantized docstrings) is used for the
    # wall-clock metric, and the signal uploads ride as per-channel-scaled
    # int16 (error ≤ 2^-15 of each channel's peak; scaling cancels exactly
    # in coherence) — arithmetic stays float32 end to end
    kw = dict(sampling_freq=FS, nw=NW, window_length_sec=WINDOW_SEC,
              overlap_frac=OVERLAP, use_jackknife=True,
              aggregate_emg_max=True, apply_independence_threshold=False,
              transfer_dtype=np.int8, input_transfer="int16")
    # warm-up / compile at the full shape
    _ = multitaper_msc(eeg, emg, **kw)
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        res = multitaper_msc(eeg, emg, **kw)
        times.append(time.perf_counter() - t0)
    elapsed = float(np.min(times))
    n_windows = res["metadata"]["n_windows"]
    rate = n_windows * N_EEG * N_EMG / elapsed
    return rate, elapsed, n_windows


def device_compute_only_rate(eeg, emg):
    """Device-resident rate (inputs pre-placed): the per-device
    capability with host↔device transfers excluded."""
    import jax
    import jax.numpy as jnp
    from scipy.stats import t as t_dist
    from mba_tpu.ops import coherence as C
    from mba_tpu.ops.dpss import filtered_tapers

    ws = int(WINDOW_SEC * FS)
    hop = int(ws * (1 - OVERLAP))
    tapers = jax.device_put(np.asarray(filtered_tapers(ws, NW, 0.9),
                                       np.float32))
    K = int(tapers.shape[0])
    starts = jnp.asarray(np.arange(0, eeg.shape[0] - ws + 1, hop),
                         jnp.int32)
    eeg_d = jax.device_put(eeg)
    emg_d = jax.device_put(emg)
    t_crit = np.float32(t_dist.ppf(0.975, K - 1))
    inv = np.float32(1.0 / (FS * ws))

    def run():
        res = C._msc_all_windows(
            eeg_d, emg_d, starts, tapers, inv, t_crit, ws, 1, True,
            True)
        return jax.block_until_ready(res)

    run()                                         # compile warm-up
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    elapsed = float(np.min(times))
    n_windows = len(starts)
    return n_windows * N_EEG * N_EMG / elapsed, elapsed, n_windows


def surrogate_null_wall(n_surrogates=10_000):
    """Config 4: single-pair 10k-surrogate null, with its stage split —
    ``null_sec`` is the regression-tracked device number."""
    from mba_tpu.ops.surrogate import msc_phase_randomized_null

    rng = np.random.default_rng(3)
    n = int(FS * SECONDS)
    eeg = rng.standard_normal((n, 1)).astype(np.float32)
    emg = rng.standard_normal((n, 1)).astype(np.float32)
    # compile warm-up at the production chunk shape (a smaller-chunk
    # warm-up would leave the real program's compile in the timed region)
    msc_phase_randomized_null(eeg, emg, FS, n_surrogates=250,
                              window_length_sec=WINDOW_SEC,
                              surrogate_chunk=250, max_stat_only=False)
    t0 = time.perf_counter()
    res = msc_phase_randomized_null(eeg, emg, FS,
                                    n_surrogates=n_surrogates,
                                    window_length_sec=WINDOW_SEC,
                                    surrogate_chunk=250,
                                    max_stat_only=False)
    elapsed = time.perf_counter() - t0
    return elapsed, res


def full_cohort_10k_null(n_subjects=12, n_surrogates=10_000):
    """THE NORTH STAR (BASELINE.json): full-cohort 64×64 CMC with a
    10k-surrogate null of the cohort statistic.

    12 subjects × 120 s @ 2048 Hz × 64 EEG × 64 EMG, 2-s windows, 50 %
    overlap, 13–100 Hz analysis band, 10 000 taper-rotation surrogates of
    the cohort-mean MSC max statistic (ops/cohort_null.py — exact algebraic
    reformulation; validated against full-FFT phase randomisation).

    Returns (total_wall, timings dict).
    """
    from mba_tpu.ops.cohort_null import cohort_msc_rotation_null

    rng = np.random.default_rng(9)
    n = int(FS * SECONDS)
    # beta-band-limited shared drive (the physical CMC shape, like the
    # study-scale config): a white shared drive at this amplitude has
    # per-bin coherence far below the correctly-calibrated disjoint
    # max-statistic's detection floor — the old white-drive assert only
    # passed against the anti-conservative all-overlapping-windows null
    f = np.fft.rfftfreq(n, 1 / FS)
    sel = (f >= 15) & (f <= 30)
    spec = np.zeros(len(f), np.complex64)
    spec[sel] = np.exp(1j * rng.uniform(0, 2 * np.pi, int(sel.sum())))
    shared = np.fft.irfft(spec, n=n).astype(np.float32)
    shared /= shared.std() + 1e-12
    eeg = np.stack([0.25 * shared[:, None]
                    + rng.standard_normal((n, N_EEG)).astype(np.float32)
                    for _ in range(n_subjects)])
    emg = np.stack([0.25 * shared[:, None]
                    + rng.standard_normal((n, N_EMG)).astype(np.float32)
                    for _ in range(n_subjects)])

    # uploads per-channel-scaled int16 (scaling cancels in MSC; error
    # ≤ 2^-15 of channel peak — int16 vs f32 equivalence is pinned by
    # tests/test_cohort_null.py)
    kw = dict(sampling_freq=FS, nw=NW, window_length_sec=WINDOW_SEC,
              overlap_frac=OVERLAP, band=(13.0, 100.0),
              surrogate_chunk=500, window_chunk=64,
              transfer_dtype=np.int16)
    # compile warm-up at the true cohort shape (the null-chunk program is
    # keyed on J; a smaller-J warm-up would leave a recompile in the timed
    # region) — one chunk of surrogates
    cohort_msc_rotation_null(eeg, emg, n_surrogates=500, **kw)

    # best of 2: the first run after warm-up can lose host cores to
    # XLA's background persistent-cache serialization
    total, res, t = np.inf, None, None
    for _ in range(2):
        t0 = time.perf_counter()
        r = cohort_msc_rotation_null(eeg, emg,
                                     n_surrogates=n_surrogates, **kw)
        wall = time.perf_counter() - t0
        if wall < total:
            total, res, t = wall, r, r["metadata"]["timings"]
    assert res["max_stat"].shape == (n_surrogates,)
    assert res["p_fwe"] < 0.01          # the planted coupling is detected
    return total, t


def full_cohort_10k_null_study_scale(n_subjects=12, n_surrogates=10_000,
                                     n_trials=30, trial_sec=45.0,
                                     silence_sec=12.0):
    """THE NORTH STAR AT TRUE STUDY SCALE.

    The real study records ~45-s task trials × ~30 per subject with
    inter-trial silences (reference statistics_data_preparation_workflow
    .py:24,126 — 12 subjects, "~40sec trials"; cbpa.py:34 — 64-ch EEG @
    2048 Hz), i.e. ≈ 22.5 min of task signal inside a ≈ 28 min recording
    per subject — ~10× the 120-s config above.  This entry runs that
    volume end to end:

    - per-subject window grid restricted to task windows via the
      ``window_starts``/``window_weights`` task mask (44 two-second
      windows per 45-s trial at 1-s hop → 1 320 task windows/subject);
    - signals stored as int8 ADC-style per-channel counts and uploaded
      verbatim (the OTB4 on-disk format is integer ADC counts,
      io/otb4.py; per-channel scaling cancels in MSC — equivalence
      pinned in tests), quartering the dominant host→device transfer;

    Stage accounting: the int8 cohort (5.3 GB — the smallest faithful
    encoding of the ADC data) is uploaded ONCE with a synced, separately
    timed ``device_put``; the coefficient pass and the null then run
    device-resident.  The single-device wall is upload + coeffs + null.

    Returns (total_wall, timings).
    """
    import jax
    from mba_tpu.ops.cohort_null import cohort_msc_rotation_null

    rng = np.random.default_rng(23)
    trial_hop = trial_sec + silence_sec
    rec_sec = n_trials * trial_hop - silence_sec
    n = int(FS * rec_sec)
    ws = int(WINDOW_SEC * FS)
    hop = int(ws * (1 - OVERLAP))

    # task-window grid: 2-s windows at 1-s hop fully inside each trial
    starts_1 = np.concatenate([
        int(i * trial_hop * FS) + np.arange(0, int(trial_sec * FS) - ws + 1,
                                            hop)
        for i in range(n_trials)]).astype(np.int64)
    starts = np.tile(starts_1[None], (n_subjects, 1))
    weights = np.ones(starts.shape, np.float32)

    # int8 ADC-count cohort, generated directly as counts (uniform
    # channel noise + a quantized beta-band shared drive): the f32
    # cohort never exists on the host, and generation is a few int
    # passes instead of 5.7 G gaussian draws
    t_gen0 = time.perf_counter()
    f = np.fft.rfftfreq(n, 1 / FS)
    sel = (f >= 15) & (f <= 30)
    spec = np.zeros(len(f), np.complex64)
    spec[sel] = np.exp(1j * rng.uniform(0, 2 * np.pi, int(sel.sum())))
    shared = np.fft.irfft(spec, n=n).astype(np.float32)
    shared /= shared.std() + 1e-12
    # drive/noise ratio 16/36.9 ≈ the previous 25/57.7; ±38 = 2.4σ clip
    drive = np.clip(np.rint(16.0 * shared), -38, 38).astype(np.int8)

    # Philox counter-based generator + power-of-2 mask: raw bytes & 127
    # is exactly uniform on [0, 127] and every op below is a single
    # int8 memory pass (no promotion, no clip — ranges can't overflow:
    # noise ∈ [−64, 63], drive ∈ [−38, 38]).
    pg = np.random.Generator(np.random.Philox(23))

    def _cohort_int8(n_ch):
        out = np.empty((n_subjects, n, n_ch), np.int8)
        for j in range(n_subjects):
            v = pg.integers(0, 128, size=(n, n_ch),
                            dtype=np.uint8).view(np.int8)
            v -= 64
            v += drive[:, None]
            out[j] = v
        return out

    eeg = _cohort_int8(N_EEG)
    emg = _cohort_int8(N_EMG)
    t_gen = time.perf_counter() - t_gen0

    kw = dict(sampling_freq=FS, nw=NW, window_length_sec=WINDOW_SEC,
              overlap_frac=OVERLAP, band=(13.0, 100.0),
              surrogate_chunk=500, window_chunk=32,
              window_starts=starts, window_weights=weights,
              overlap_upload=False)

    t = {}
    t0 = time.perf_counter()
    upload_bytes = eeg.nbytes + emg.nbytes
    eeg_d = jax.device_put(eeg)
    emg_d = jax.device_put(emg)
    jax.block_until_ready((eeg_d, emg_d))
    t["upload_sec"] = round(time.perf_counter() - t0, 2)
    t["upload_bytes"] = int(upload_bytes)
    del eeg, emg

    # warm-up at full shape (compiles the J=12 coefficient program; no
    # transfer — the cohort is already resident.  The null-chunk program
    # is shape-identical to the 120-s config's and is warmed there)
    cohort_msc_rotation_null(eeg_d, emg_d, precompute_only=True, **kw)

    t1 = time.perf_counter()
    res = cohort_msc_rotation_null(eeg_d, emg_d,
                                   n_surrogates=n_surrogates, **kw)
    t_compute = time.perf_counter() - t1
    # single-device wall = synced upload + warm compute (the warm-up
    # between them only pays one-time XLA compiles)
    total = t["upload_sec"] + t_compute
    tt = res["metadata"]["timings"]
    t["coeffs_sec"] = tt.get("coeffs_sec", tt.get("precompute_sec"))
    t["null_sec"] = tt["null_sec"]
    t["compute_sec_device"] = round(t_compute, 2)
    t["generate_sec_host"] = round(t_gen, 2)
    t["task_signal_min_per_subject"] = round(
        n_trials * trial_sec / 60.0, 1)
    t["n_task_windows_per_subject"] = int(starts.shape[1])
    assert res["max_stat"].shape == (n_surrogates,)
    assert res["p_fwe"] < 0.01          # planted coupling detected
    return total, t


def single_pair_pipeline_wall():
    """BASELINE.json config 1: zero-phase bandpass + notch + epoch +
    CMC spectrum for a single EEG×EMG pair."""
    from mba_tpu.ops.filters import bandpass_filter, notch_filter
    from mba_tpu.ops.coherence import multitaper_msc

    rng = np.random.default_rng(1)
    n = int(FS * SECONDS)
    eeg = rng.standard_normal((n, 1)).astype(np.float32)
    emg = rng.standard_normal((n, 1)).astype(np.float32)

    def run():
        e = notch_filter(bandpass_filter(eeg, FS, 0.1, 100.0), FS,
                         [50.0 * i for i in range(1, 5)])
        m = notch_filter(bandpass_filter(emg, FS, 20.0, 500.0), FS,
                         [50.0 * i for i in range(1, 5)])
        return multitaper_msc(np.asarray(e), np.asarray(m), FS, nw=NW,
                              window_length_sec=WINDOW_SEC,
                              overlap_frac=OVERLAP, use_jackknife=True,
                              apply_independence_threshold=False)

    run()                                    # compile warm-up
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


def batched_preprocessing_rate():
    """BASELINE.json config 2: batched 64-ch bandpass + notch + epoch.

    The upload is timed separately (once), and the tracked rate is the
    device-resident compute synced inside the timed region.
    """
    import jax
    import jax.numpy as jnp
    from mba_tpu.ops.filters import bandpass_filter, notch_filter
    from mba_tpu.ops.framing import frame_signal

    rng = np.random.default_rng(2)
    n = int(FS * SECONDS)
    data = rng.standard_normal((n, N_EEG)).astype(np.float32)

    ws = int(WINDOW_SEC * FS)
    hop = int(ws * (1 - OVERLAP))
    starts = np.arange(0, n - ws + 1, hop)

    t_up0 = time.perf_counter()
    data_d = jax.block_until_ready(jax.device_put(data))
    t_upload = time.perf_counter() - t_up0

    def run():
        x = bandpass_filter(data_d, FS, 0.1, 100.0)
        x = notch_filter(x, FS, [50.0 * i for i in range(1, 5)])
        return jax.block_until_ready(frame_signal(x, starts, ws))

    run()                                    # compile warm-up
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    elapsed = float(np.min(times))
    return n * N_EEG / elapsed, elapsed, t_upload   # channel-samples/s


def cohort_permutation_rate(n_permutations=1000):
    """BASELINE.json config 5: spatio-temporal cluster permutation
    omnibus over a 12-subject cohort contrast."""
    from mba_tpu.ops.permutation import (cluster_permutation_1samp_test,
                                         delaunay_channel_adjacency,
                                         combine_adjacency)
    from mba_tpu.pipeline.cbpa import CMC_EEG_CHANNEL_SUBSET

    rng = np.random.default_rng(5)
    n_subj, n_times = 12, 40
    ch = CMC_EEG_CHANNEL_SUBSET
    X = (0.3 + rng.standard_normal((n_subj, n_times, len(ch)))
         ).astype(np.float32)
    adj = combine_adjacency(n_times, delaunay_channel_adjacency(ch))
    # one device dispatch for the whole null (compile warm-up first)
    cluster_permutation_1samp_test(X, adj, n_permutations=n_permutations,
                                   tail=1,
                                   permutation_chunk=n_permutations)
    t0 = time.perf_counter()
    cluster_permutation_1samp_test(X, adj, n_permutations=n_permutations,
                                   tail=1,
                                   permutation_chunk=n_permutations)
    elapsed = time.perf_counter() - t0
    return n_permutations / elapsed, elapsed


def batched_lme_rate(n_sims=2000, n_subj=12, n_per=10):
    """Cohort-statistics support metric: batched random-intercept REML
    refits/s (the loops behind power analysis + clustered bootstrap)."""
    from mba_tpu.models.lme import batched_lme_pvalues

    rng = np.random.default_rng(7)
    n = n_subj * n_per
    groups = np.repeat(np.arange(n_subj), n_per)
    X = np.column_stack([np.ones(n), rng.standard_normal(n)])
    re = rng.normal(0, 0.8, size=(n_sims, n_subj))[:, groups]
    Y = (0.3 * X[:, 1] + re
         + rng.normal(0, 1.0, size=(n_sims, n))).astype(np.float32)
    batched_lme_pvalues(X, Y, groups)           # compile warm-up
    t0 = time.perf_counter()
    out = batched_lme_pvalues(X, Y, groups)
    elapsed = time.perf_counter() - t0
    assert np.isfinite(out["pvalues"]).all()
    return n_sims / elapsed, elapsed


def main() -> int:
    log(f"card: {card_name()}")
    eeg, emg = make_signals()
    log(f"workload: {SECONDS:.0f}s @ {FS:.0f} Hz, {N_EEG}x{N_EMG} pairs, "
        f"{WINDOW_SEC}s windows, jackknife CIs")
    extras = {}
    failed = []

    def phase(name, fn):
        """Run one secondary phase; a failure is logged, recorded and
        makes the script exit non-zero after the final line."""
        try:
            fn()
        except Exception as e:
            log(f"{name} failed: {e!r}")
            failed.append(name)

    import jax
    dev = jax.devices()[0]
    extras["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                        "count": len(jax.devices())}
    rate_dev, t_dev_e2e, n_windows = device_rate(eeg, emg)
    log(f"{dev.device_kind}: {n_windows} windows in {t_dev_e2e:.3f}s "
        f"→ {rate_dev:,.0f} spectra/s")

    rate_cpu_live, t_cpu = cpu_reference_rate(eeg, emg)
    log(f"CPU reference (live): {t_cpu:.2f}s for 2 windows "
        f"→ {rate_cpu_live:,.0f} spectra/s")
    pinned = pinned_cpu()
    rate_cpu = pinned.get("cmc_spectra_per_sec_cpu", rate_cpu_live)
    log(f"CPU reference (pinned, used for vs_baseline): "
        f"{rate_cpu:,.0f} spectra/s")
    extras["cpu_spectra_per_sec_live"] = round(rate_cpu_live, 1)
    extras["cpu_spectra_per_sec_pinned"] = round(rate_cpu, 1)

    def north_star():
        t_ns, tt = full_cohort_10k_null()
        cpu_ns = pinned.get("cohort_null_cpu_sec_10k_12subj_extrapolated")
        log(f"full-cohort 10k-surrogate null (12 subj, 64x64, 13-100 Hz): "
            f"{t_ns:.1f}s single-device wall (quantize "
            f"{tt.get('quantize_sec', '?')}s + upload‖coeffs "
            f"{tt.get('upload_coeffs_overlap_sec', '?')}s + null "
            f"{tt['null_sec']}s)"
            + (f"; numpy CPU extrapolation: {cpu_ns:,.0f}s"
               if cpu_ns else ""))
        extras["full_cohort_10k_null_sec_single_device"] = round(t_ns, 2)
        extras["full_cohort_10k_null_stages"] = tt
        if cpu_ns:
            extras["full_cohort_10k_null_cpu_sec_pinned"] = cpu_ns

    def study_scale():
        t_ss, tss = full_cohort_10k_null_study_scale()
        log(f"full-cohort null at study scale "
            f"({tss['task_signal_min_per_subject']} min task "
            f"signal/subject, {tss['n_task_windows_per_subject']} task "
            f"windows, int8 ADC cohort): {t_ss:.1f}s single-device wall "
            f"(upload {tss['upload_sec']}s + coeffs {tss['coeffs_sec']}s "
            f"+ null {tss['null_sec']}s)")
        extras["full_cohort_10k_null_study_scale_sec_single_device"] = \
            round(t_ss, 2)
        extras["full_cohort_10k_null_study_scale_stages"] = tss

    def compute_only():
        rate_c, t_c, nw_c = device_compute_only_rate(eeg, emg)
        log(f"compute-only (device-resident): {nw_c} windows in "
            f"{t_c:.3f}s → {rate_c:,.0f} spectra/s "
            f"({rate_c / rate_cpu:,.0f}x CPU)")
        extras["compute_only_spectra_per_sec_device"] = round(rate_c, 1)
        extras["compute_only_vs_cpu_pinned"] = round(rate_c / rate_cpu, 1)

    def single_pair_null():
        t_null, res_null = surrogate_null_wall()
        st = res_null.get("timings", {})
        log(f"10k-surrogate single-pair null: {t_null:.2f}s wall "
            f"(upload {st.get('upload_sec', '?')}s + observed "
            f"{st.get('observed_sec', '?')}s + null "
            f"{st.get('null_sec', '?')}s ← tracked)")
        extras["single_pair_10k_null_stages"] = st
        extras["single_pair_10k_null_sec_wall"] = round(t_null, 2)

    def config1():
        t_pair = single_pair_pipeline_wall()
        log(f"config-1 single-pair filter+notch+CMC: {t_pair:.2f}s wall")

    def config2():
        rate_pre, t_pre, t_pre_up = batched_preprocessing_rate()
        log(f"config-2 batched 64-ch preprocessing (device-resident, "
            f"synced): {t_pre:.3f}s → {rate_pre:,.0f} channel-samples/s "
            f"(one-time upload {t_pre_up:.2f}s)")
        extras["preprocessing_channel_samples_per_sec_device"] = \
            round(rate_pre, 0)
        extras["preprocessing_upload_sec"] = round(t_pre_up, 2)

    def config5():
        rate_perm, t_perm = cohort_permutation_rate()
        log(f"config-5 cohort cluster permutations: {t_perm:.2f}s "
            f"→ {rate_perm:,.0f} permutations/s")

    def config5b():
        rate_lme, t_lme = batched_lme_rate()
        log(f"config-5b batched REML LME: {t_lme:.2f}s "
            f"→ {rate_lme:,.0f} refits/s")

    for name, fn in (("full-cohort null", north_star),
                     ("study-scale null", study_scale),
                     ("compute-only", compute_only),
                     ("single-pair null", single_pair_null),
                     ("config-1", config1), ("config-2", config2),
                     ("config-5", config5), ("config-5b", config5b)):
        phase(name, fn)

    # the null engines' statistical power is a property of the estimator,
    # measured on the CPU by tools/bench_null_power.py
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "BENCH_NULL_POWER.json")) as fh:
        npow = json.load(fh)
    extras["null_power_max_gap_auto"] = npow.get(
        "max_power_gap_fullfft_minus_auto")
    extras["null_power_max_gap_rotation_arm"] = npow.get(
        "max_power_gap_fullfft_minus_rotation")
    if failed:
        extras["failed_phases"] = ",".join(failed)

    print(render_final_line(rate_dev, rate_cpu, extras), flush=True)
    return 1 if failed else 0


# The driver tail-captures ~2000 chars of stdout; stay well under it so
# the parsed record survives (a 6.3 KB line once lost a whole record).
MAX_FINAL_LINE_CHARS = 1800


def render_final_line(rate_dev, rate_cpu, extras) -> str:
    """Compose the one-line JSON record, guaranteed parseable by the
    driver: if nested stage dicts push the line over the budget, they
    are dropped (scalars always survive)."""
    def payload(ex):
        return json.dumps({
            "metric": "cmc_spectra_per_sec_per_device",
            "value": round(rate_dev, 1),
            "unit": "window-pair spectra/s (64x64, jackknife)",
            "vs_baseline": round(rate_dev / rate_cpu, 2),
            "extras": ex,
        })

    line = payload(extras)
    if len(line) <= MAX_FINAL_LINE_CHARS:
        return line
    slim = {k: v for k, v in extras.items()
            if not isinstance(v, (dict, list))}
    line = payload(slim)
    if len(line) <= MAX_FINAL_LINE_CHARS:
        return line
    # last resort: keep the primary-metric scalars only
    keep = ("compute_only_spectra_per_sec_device",
            "full_cohort_10k_null_study_scale_sec_single_device",
            "cpu_spectra_per_sec_pinned", "failed_phases")
    return payload({k: slim[k] for k in keep if k in slim})


if __name__ == "__main__":
    sys.exit(main())
