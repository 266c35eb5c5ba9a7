"""End-to-end five-stage pipeline benchmark at study scale — with
scientific-correctness gates.

The reference is a *pipeline* (reference src/README.md:95-126):
otb4 import → preprocessing → feature extraction → statistics frame →
omnibus + CBPA + report.  This tool drives the repo's REAL pipeline
modules:

- stages 1-3 (the array-heavy per-subject work) on ONE synthetic
  subject at the study's true scale (30 × 45-s trials @ 2048 Hz,
  ≈28-min recording; statistics_data_preparation_workflow.py:24,126),
- stages 4-5 (the cohort statistics) on a 12-subject artifact tree:
  subject 0's artifacts are the real stage-3 outputs; subjects 1-11
  carry condition-preserving jittered copies of those artifacts (the
  reference would repeat stages 1-3 per subject — that cost is
  subject-count-linear and not re-measured here), all flowing through
  the REAL loaders/assembly (build_subject_frame, build_contrast_array).

Stage 4 builds the Combined Statistics frames at ALL FOUR reference
time resolutions (1/2/5/10 segments); stage 5 runs the omnibus at
reference breadth (14 hypothesis DVs × 4 comparison levels × 4
resolutions + FDR; reference statistics_RQ_A_omnibus_testing_workflow
.py:371-541), CBPA through the real spectrogram-assembly path
(reference cbpa.py:733-1067), a LOSO influence pass and a batched-REML
power run, and the Markdown report.

Scientific-correctness gates (the bench FAILS if the pipeline destroys
its planted signal):
  G1  post-ICA task-window CMC in 16-28 Hz exceeds the Beta(K−2,K−2)
      independence threshold (reference signal_features.py:470-481)
  G2  music-trial CMC >> silence-trial CMC on the Fisher-z scale
      (the planted contrast: silence couples at 0.4× gain; z-gap
      > 0.15 and one-sided Welch p < 1e-3 across windows)
  G3  the omnibus Level-0 music-vs-silence effect on
      CMC_Flexor_max_beta is detected (positive, p < 0.05)
  G4  CBPA finds ≥1 significant cluster for the Happy-vs-Silence
      contrast

Writes ``BENCH_PIPELINE.json`` next to the repo root.  Run time
≈ 5-10 min: ``python tools/bench_pipeline.py``
"""
from __future__ import annotations

import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import synth_study as S                                   # noqa: E402

FS = S.FS
N_EEG = S.N_EEG
N_EMG = S.N_EMG
N_ICA = 25
WINDOW_SEC = 2.0
PSD_WINDOW_SEC = 1.0
N_SUBJECTS = 12
BETA_DRIVE = S.BETA_DRIVE


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class CompileMeter:
    """Accumulates jax compile-path seconds (trace + lowering + backend
    compile) via the monitoring listener, so every stage wall can be
    split into ``*_compile_sec`` vs steady-state work.  With
    the persistent compilation cache (mba_tpu/_config.py) warm, the
    backend_compile term collapses and the split shows it.
    """

    def __init__(self):
        import jax
        self.total = 0.0
        self._mark = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._cb)

    def _cb(self, event, dur, **kw):
        if event.startswith("/jax/core/compile/"):
            self.total += dur

    def mark(self):
        self._mark = self.total

    def since_mark(self) -> float:
        return round(self.total - self._mark, 2)


# ── CPU denominators (reference-style numpy/scipy) ────────────────────
def cpu_filter_denominator(x_slice, fs):
    import scipy.signal
    taps_bp = scipy.signal.firwin(8193, [1.0, 100.0], fs=fs,
                                  pass_zero=False, window="hamming")
    t0 = time.perf_counter()
    y = scipy.signal.fftconvolve(x_slice, taps_bp[:, None], mode="same",
                                 axes=0)
    for f0 in (50.0, 100.0, 150.0, 200.0):
        b, a = scipy.signal.iirnotch(f0, 30.0, fs=fs)
        y = scipy.signal.filtfilt(b, a, y, axis=0)
    return time.perf_counter() - t0


def cpu_ica_epoch_denominator(x_white, block, n_comp, rng):
    n = x_white.shape[0]
    n_blocks = n // block
    w = np.eye(n_comp, dtype=np.float32)
    signs = np.ones(n_comp, np.float32)
    lrate = np.float32(1e-7)
    eye = np.eye(n_comp, dtype=np.float32)
    perm = rng.permutation(n)[:n_blocks * block]
    data = x_white[perm].reshape(n_blocks, block, n_comp)
    t0 = time.perf_counter()
    for xb in data:
        u = xb @ w
        y = np.tanh(u)
        w = w + lrate * (w @ (block * eye - signs[None, :] * (u.T @ y)
                              - u.T @ u))
    return time.perf_counter() - t0


def cpu_psd_denominator(x_slice, fs, window_sec, n_total, n_arrays=3):
    """Reference multitaper PSD: per-window per-taper scipy periodogram
    averaged over K tapers (reference signal_features.py:391-429),
    timed on a slice and extrapolated linearly in samples."""
    import scipy.signal
    wlen = int(window_sec * fs)
    hop = wlen // 2
    tapers = scipy.signal.windows.dpss(wlen, 3, Kmax=5)
    n_win = (len(x_slice) - wlen) // hop + 1
    t0 = time.perf_counter()
    for w in range(n_win):
        seg = x_slice[w * hop: w * hop + wlen]
        acc = None
        for tap in tapers:
            _, p = scipy.signal.periodogram(seg * tap[:, None], fs=fs,
                                            axis=0, window="boxcar",
                                            detrend=False)
            acc = p if acc is None else acc + p
        np.log10(acc / len(tapers) + 1e-10)
    dt = time.perf_counter() - t0
    return dt * (n_total / len(x_slice)) * n_arrays


def cpu_cbpa_perm_denominator(X, adjacency, t_thresh, n_perms_target,
                              n_probe=32):
    """Reference-style permutation clustering: per sign-flip, a numpy
    t-map + scipy connected-component cluster masses (the work MNE's
    permutation_cluster_1samp_test does per permutation,
    reference cbpa.py:1027-1042), timed on a probe and extrapolated."""
    from scipy.sparse.csgraph import connected_components
    from scipy import sparse
    n_subj = X.shape[0]
    flat = X.reshape(n_subj, -1)
    adj = sparse.csr_matrix(adjacency)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for _ in range(n_probe):
        signs = rng.choice([-1.0, 1.0], size=n_subj)[:, None]
        xs = flat * signs
        m = xs.mean(0)
        sd = xs.std(0, ddof=1)
        tmap = m / (sd / np.sqrt(n_subj) + 1e-12)
        supra = tmap > t_thresh
        if supra.any():
            sub = adj[supra][:, supra]
            n_c, labels = connected_components(sub, directed=False)
            np.array([tmap[supra][labels == c].sum()
                      for c in range(n_c)]).max()
    dt = time.perf_counter() - t0
    return dt * (n_perms_target / n_probe)


# ── replica artifact jitter ───────────────────────────────────────────
def write_replica_artifacts(feat_root: Path, subject: int,
                            psd_aggs: dict, cmc_aggs: dict,
                            channel_suffix: str):
    """Condition-preserving per-subject jitter of subject 0's lean
    band-aggregate artifacts.  CMC: multiplicative subject effect +
    additive noise (keeps the planted music-vs-silence contrast while
    adding between-subject variance for the LME's random intercepts);
    PSD: per-subject offset + noise in the artifact's log10 domain."""
    from mba_tpu.pipeline import signal_features as features
    rng = np.random.default_rng(5000 + subject)
    sub_dir = feat_root / f"subject_{subject:02}"
    sub_dir.mkdir(parents=True, exist_ok=True)
    for modality, (payload, tc, names, edges) in psd_aggs.items():
        jit = payload + rng.normal(0, 0.10) \
            + rng.normal(0, 0.03, payload.shape).astype(np.float32)
        features.save_band_aggregates(jit, tc, names, edges, "PSD",
                                      sub_dir, identifier_suffix=modality)
    for muscle, (payload, tc, names, edges) in cmc_aggs.items():
        a_s = rng.normal(1.0, 0.08)
        jit = np.clip(payload * a_s
                      + rng.normal(0, 0.01, payload.shape)
                      .astype(np.float32), 0.0, 1.0)
        features.save_band_aggregates(
            jit, tc, names, edges, "CMC", sub_dir,
            identifier_suffix=f"{muscle} Trial-wise {channel_suffix}")


def main():
    import jax
    import pandas as pd
    from mba_tpu.io.otb4 import write_otb4, read_otb4
    from mba_tpu.utils.transfer import upload_counts, upload_quantized
    from mba_tpu.pipeline.preprocessing import BiosignalPreprocessor
    from mba_tpu.pipeline import signal_features as features
    from mba_tpu.pipeline import data_integration as di
    from mba_tpu.pipeline import data_analysis
    from mba_tpu.pipeline.cbpa import CMC_EEG_CHANNEL_SUBSET
    from mba_tpu.utils import file_management as filemgmt

    stages = {}
    detail = {}
    denominators = {}
    gates = {}
    platform = jax.devices()[0].platform
    meter = CompileMeter()

    def compile_split(key: str):
        """Record compile seconds accumulated since the last mark."""
        detail[f"{key}_compile_sec"] = meter.since_mark()
        meter.mark()

    # ── stage 0: synthesis (signals + 12-subject artifact tree) ───────
    log("[synth] generating study at true scale …")
    t0 = time.perf_counter()
    plan = S.TrialPlan()
    eeg, emg1, emg2 = S.synth_subject(plan)
    n = eeg.shape[0]
    rec_sec = plan.rec_sec
    work = Path(tempfile.mkdtemp(prefix="bench_pipeline_"))
    exp_root = work / "data" / "experiment_results"
    feat_root = work / "data" / "precomputed_features"
    feat_root.mkdir(parents=True)
    for subject in range(N_SUBJECTS):
        S.write_subject_tree(exp_root, subject, plan,
                             write_raw_serial=(subject == 0))
    lookup_path = S.write_music_lookup(
        work / "data" / "song_characteristics", plan)
    stages["synthesis_sec_host"] = round(time.perf_counter() - t0, 2)
    log(f"[synth] {rec_sec/60:.1f} min recording, "
        f"{plan.n_songs} music + {plan.n_silence} silence trials, "
        f"{N_SUBJECTS}-subject tree ({stages['synthesis_sec_host']}s)")

    try:
        # ── stage 1: OTB4 import (the real archive reader) ────────────
        p1 = work / "emg_flexor.otb4"
        p2 = work / "emg_extensor.otb4"
        write_otb4(p1, emg1.T, FS)
        write_otb4(p2, emg2.T, FS)
        t0 = time.perf_counter()
        r1 = read_otb4(p1, raw_counts=True)
        r2 = read_otb4(p2, raw_counts=True)
        emg1_counts = r1["signals"][0][1].T
        emg2_counts = r2["signals"][0][1].T
        emg1_vpc = r1["mv_per_count"][0]
        emg2_vpc = r2["mv_per_count"][0]
        stages["s1_otb4_import_sec"] = round(time.perf_counter() - t0, 2)
        log(f"[s1] otb4 import 2×{N_EMG}ch×{rec_sec/60:.0f}min: "
            f"{stages['s1_otb4_import_sec']}s")

        # ── stage 2: preprocessing (full cascade incl. ICA) ───────────
        meter.mark()
        t0 = time.perf_counter()
        eeg_d, up_bytes, up_err = upload_quantized(eeg, np.int16)
        jax.block_until_ready(eeg_d)
        stages["s2_eeg_upload_sec"] = round(time.perf_counter() - t0, 2)
        detail["s2_eeg_upload_bytes"] = int(up_bytes)
        detail["s2_eeg_upload_quant_err_mv"] = float(f"{up_err:.2e}")
        prep = BiosignalPreprocessor(
            eeg_d, int(FS), "eeg", n_ica_components=N_ICA,
            automatic_ic_labelling=True, wavelet_type=None,
            amplitude_rejection_threshold=3.0, device_resident=True)
        t0 = time.perf_counter()
        jax.block_until_ready(prep.np_filtered_data)
        t_filter = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(prep.np_amplitude_compliant_data)
        t_refamp = time.perf_counter() - t0
        t0 = time.perf_counter()
        ica = prep.ica_result
        t_ica = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(prep.np_artefact_free_data)
        t_ica_apply = time.perf_counter() - t0
        n_excluded = len(ica.exclude)
        t0 = time.perf_counter()
        eeg_clean = prep.np_output_data
        jax.block_until_ready(eeg_clean)
        t_spatial = time.perf_counter() - t0
        stages["s2_eeg_filter_sec"] = round(t_filter, 2)
        stages["s2_eeg_reference_amplitude_sec"] = round(t_refamp, 2)
        stages["s2_eeg_ica_fit_sec"] = round(t_ica, 2)
        stages["s2_eeg_ica_label_apply_sec"] = round(t_ica_apply, 2)
        stages["s2_eeg_spatial_sec"] = round(t_spatial, 2)
        stages["s2_eeg_ica_n_iter"] = int(ica.n_iter_)
        stages["s2_eeg_ica_n_excluded"] = int(n_excluded)
        compile_split("s2_eeg")
        log(f"[s2] EEG cascade: filter {t_filter:.1f}s, ref+amp "
            f"{t_refamp:.1f}s, ICA fit {t_ica:.1f}s ({ica.n_iter_} iters,"
            f" {n_excluded} ICs excluded), apply {t_ica_apply:.1f}s, "
            f"spatial {t_spatial:.1f}s "
            f"(compile {detail['s2_eeg_compile_sec']}s)")

        # CPU denominators needing `eeg`/`ica`
        slice_n = int(30 * FS)
        d = cpu_filter_denominator(eeg[:slice_n], FS)
        denominators["s2_filter_cpu_sec_extrapolated"] = round(
            d * (n / slice_n) * 3, 1)
        x_white = ica.get_sources(eeg[:int(60 * FS)])[:, :N_ICA].astype(
            np.float32)
        block = max(8, int(np.sqrt(n / 3.0)))
        epoch_slice = cpu_ica_epoch_denominator(
            x_white, block, N_ICA, np.random.default_rng(0))
        epoch_full = epoch_slice * (n // block) / max(
            len(x_white) // block, 1)
        denominators["s2_ica_cpu_sec_extrapolated_live"] = round(
            epoch_full * max(ica.n_iter_, 1), 1)
        pinned = {}
        ppin = REPO / "BENCH_CPU_PINNED.json"
        if ppin.exists():
            pinned = json.loads(ppin.read_text())
        per_ms = pinned.get("ica_cpu_sec_per_epoch_per_msample")
        if per_ms is not None:
            denominators["s2_ica_cpu_sec_extrapolated"] = round(
                per_ms * (n / 1e6) * max(ica.n_iter_, 1), 1)
        else:
            denominators["s2_ica_cpu_sec_extrapolated"] = \
                denominators["s2_ica_cpu_sec_extrapolated_live"]
        denominators["s3_psd_cpu_sec_extrapolated"] = round(
            cpu_psd_denominator(eeg[:int(20 * FS)], FS, PSD_WINDOW_SEC,
                                n), 1)
        del eeg
        prep.free_intermediate_stages()
        del prep, ica

        meter.mark()
        t0 = time.perf_counter()
        emg1_d, nb1 = upload_counts(emg1_counts, emg1_vpc[None, :])
        emg1_clean = BiosignalPreprocessor(
            emg1_d, int(FS), "emg", n_ica_components=None,
            automatic_ic_labelling=False, wavelet_type=None,
            laplacian_filter_neighbor_radius=None,
            amplitude_rejection_threshold=3.0,
            device_resident=True).np_output_data
        emg2_d, nb2 = upload_counts(emg2_counts, emg2_vpc[None, :])
        emg2_clean = BiosignalPreprocessor(
            emg2_d, int(FS), "emg", n_ica_components=None,
            automatic_ic_labelling=False, wavelet_type=None,
            laplacian_filter_neighbor_radius=None,
            amplitude_rejection_threshold=3.0,
            device_resident=True).np_output_data
        jax.block_until_ready((emg1_clean, emg2_clean))
        detail["s2_emg_upload_bytes"] = int(nb1 + nb2)
        stages["s2_emg_cascade_sec"] = round(time.perf_counter() - t0, 2)
        compile_split("s2_emg")
        log(f"[s2] EMG cascades: {stages['s2_emg_cascade_sec']}s "
            f"(compile {detail['s2_emg_compile_sec']}s)")
        del emg1, emg2, emg1_counts, emg2_counts

        # ── stage 3: feature extraction ───────────────────────────────
        subj0_feat = feat_root / "subject_00"
        subj0_feat.mkdir()
        subj0_exp = exp_root / "subject_00"
        log_df = di.fetch_enriched_log_frame(subj0_exp, verbose=False)
        log_df.index = data_analysis.make_timezone_aware(log_df.index)

        # 3a. PSD → on-device band aggregates (the lean feature store):
        # the full (windows, freqs, channels) grid is never downloaded;
        # the band aggregates are ~4 MB and carry exactly what stages
        # 4-5 consume.  The full grid stays recomputable on the device.
        psd_aggs = {}
        t_psd_comp = t_psd_down = psd_mb = 0.0
        meter.mark()
        t_stage0 = time.perf_counter()
        for modality, arr in (("eeg", eeg_clean),
                              ("emg_1_flexor", emg1_clean),
                              ("emg_2_extensor", emg2_clean)):
            t0 = time.perf_counter()
            s_dev, tc_, fr_ = features.multitaper_psd(
                arr, FS, nw=3, window_length_sec=PSD_WINDOW_SEC,
                overlap_frac=0.5, axis=0, apply_log_scale=True,
                device_output=True)
            payload_dev, names, edges = \
                features.band_aggregate_spectrogram(s_dev, fr_)
            jax.block_until_ready(payload_dev)
            t_psd_comp += time.perf_counter() - t0
            t0 = time.perf_counter()
            payload = np.asarray(payload_dev, dtype=np.float32)
            t_psd_down += time.perf_counter() - t0
            psd_mb += payload.nbytes / 1e6
            del s_dev, payload_dev
            features.save_band_aggregates(payload, tc_, names, edges,
                                          "PSD", subj0_feat,
                                          identifier_suffix=modality)
            psd_aggs[modality] = (payload, tc_, names, edges)
        t_psd = time.perf_counter() - t_stage0
        stages["s3_psd_sec"] = round(t_psd, 2)
        detail["s3_psd_compute"] = round(t_psd_comp, 2)
        detail["s3_psd_download"] = round(t_psd_down, 2)
        detail["s3_psd_download_mb"] = round(psd_mb, 1)
        compile_split("s3_psd")

        # 3b. task-wise CMC through the REAL log-driven mask path
        t0 = time.perf_counter()
        cmc_results = {}
        channel_suffix = f"Channels_{'_'.join(CMC_EEG_CHANNEL_SUBSET)}"
        cmc_aggs = {}
        K_tapers = None
        for muscle, arr in (("flexor", emg1_clean),
                            ("extensor", emg2_clean)):
            tm = {}
            cmc_results[muscle] = features.compute_task_wise_aggregated_cmc(
                eeg_clean, arr, int(FS), muscle_group=muscle,
                log_frame=log_df,
                eeg_channel_subset=CMC_EEG_CHANNEL_SUBSET,
                window_size_sec=WINDOW_SEC, window_overlap_ratio=0.5,
                use_jackknife=True, save_dir=subj0_feat,
                timings_out=tm, transfer_dtype=np.int8,
                # every downstream consumer (AGGREGATE_BANDS top edge,
                # CBPA beta contrasts, gates) lives under 250 Hz — slice
                # the 1024-Hz grid on device and download 1/4 the bytes
                freq_range=(0.0, 250.0))
            K_tapers = tm.pop("K_tapers", K_tapers)
            for k, v in tm.items():
                detail[f"s3_cmc_{muscle}_{k}"] = v
            coh, lo, up, tc_c, fr_c = cmc_results[muscle]
            payload, names, edges = features.band_aggregate_spectrogram(
                coh, fr_c)
            cmc_aggs[muscle.capitalize()] = (payload, tc_c, names, edges)
        t_cmc = time.perf_counter() - t0
        stages["s3_cmc_sec"] = round(t_cmc, 2)
        compile_split("s3_cmc")

        # 3c. enriched serial frame through the REAL path (subject 0)
        t0 = time.perf_counter()
        serial0 = __import__(
            "mba_tpu.workflows.subject_feature_extraction_workflow",
            fromlist=["build_enriched_serial_frame"]
        ).build_enriched_serial_frame(subj0_exp)
        stages["s3_serial_sec"] = round(time.perf_counter() - t0, 2)

        coh, lo_ci, up_ci, tc, fr = cmc_results["flexor"]
        n_active = int((coh.sum(axis=(1, 2)) != 0).sum())
        cpu_rate = pinned.get("cmc_spectra_per_sec_cpu", 958.0)
        denominators["s3_cmc_cpu_sec_pinned_rate"] = round(
            n_active * len(CMC_EEG_CHANNEL_SUBSET) * N_EMG * 2 / cpu_rate,
            1)
        log(f"[s3] PSD→band-aggs {t_psd:.1f}s ({psd_mb:.1f} MB download); "
            f"task CMC {t_cmc:.1f}s ({n_active} active windows); serial "
            f"{stages['s3_serial_sec']}s")
        del eeg_clean, emg1_clean, emg2_clean

        # ── GATES G1/G2: the planted beta drive survived ──────────────
        from mba_tpu.ops.coherence import cmc_independence_threshold
        qs, _qe = di.get_qtc_measurement_start_end(log_df, False)
        beta_sel = (fr >= BETA_DRIVE[0]) & (fr <= BETA_DRIVE[1])

        def peak_cmc_per_window(spans):
            """Per-window beta-peak CMC (channel-mean) + Fisher-z.

            MSC is bounded at 1 and the peak-over-band statistic
            saturates near that ceiling (measured: music 0.954 vs
            silence 0.902 at the planted 1.0/0.4 gains), so the
            contrast gate works on the variance-stabilised Fisher
            scale z = atanh(√MSC) — the same transform coherence
            inference uses — where the same run shows a 0.39 gap.
            """
            sel = np.zeros(len(tc), bool)
            for (t_s, t_e) in spans:
                sel |= (tc >= t_s + WINDOW_SEC / 2) \
                    & (tc <= t_e - WINDOW_SEC / 2)
            peak = coh[np.ix_(sel, beta_sel)].max(axis=1)
            peak = peak.reshape(peak.shape[0], -1).mean(axis=1)
            z = np.arctanh(np.sqrt(np.clip(peak, 0.0, 1.0 - 1e-7)))
            return float(np.nanmean(peak)), z, int(sel.sum())

        music_cmc, z_music, n_music = peak_cmc_per_window(
            plan.signal_relative_spans("music"))
        silence_cmc, z_sil, n_sil = peak_cmc_per_window(
            plan.signal_relative_spans("silence"))
        from scipy import stats as sp_stats
        z_gap = float(np.nanmean(z_music) - np.nanmean(z_sil))
        t_stat, p_one = sp_stats.ttest_ind(
            z_music[~np.isnan(z_music)], z_sil[~np.isnan(z_sil)],
            equal_var=False, alternative="greater")
        thresh = float(cmc_independence_threshold(int(K_tapers)))
        gates["g1_music_cmc_beta"] = round(music_cmc, 4)
        gates["g1_beta_threshold_K"] = int(K_tapers)
        gates["g1_beta_threshold"] = round(thresh, 4)
        gates["g2_silence_cmc_beta"] = round(silence_cmc, 4)
        gates["g2_fisher_z_gap"] = round(z_gap, 4)
        gates["g2_welch_t"] = round(float(t_stat), 2)
        gates["g2_welch_p_one_sided"] = float(p_one)
        gates["g2_n_windows"] = [n_music, n_sil]
        if not (music_cmc > thresh):
            raise AssertionError(
                f"GATE G1 FAILED: post-ICA music-trial beta CMC "
                f"{music_cmc:.3f} ≤ Beta(K−2,K−2) threshold {thresh:.3f} "
                f"— the pipeline destroyed the planted drive "
                f"({n_excluded} ICs were excluded)")
        if not (z_gap > 0.15 and p_one < 1e-3):
            raise AssertionError(
                f"GATE G2 FAILED: music z {np.nanmean(z_music):.3f} vs "
                f"silence z {np.nanmean(z_sil):.3f} (gap {z_gap:.3f}, "
                f"Welch p={p_one:.2e}, n={n_music}/{n_sil}) — planted "
                f"1.0-vs-0.4 contrast lost")
        log(f"[gate] G1 music CMC {music_cmc:.3f} > threshold "
            f"{thresh:.3f} (K={K_tapers}); G2 z-gap {z_gap:.3f} "
            f"(music {np.nanmean(z_music):.2f} vs silence "
            f"{np.nanmean(z_sil):.2f}, Welch t={t_stat:.1f}, "
            f"p={p_one:.1e}) — planted contrast survived "
            f"{n_excluded}-IC exclusion")

        # replica artifacts + serial for subjects 1-11 (synthesis cost,
        # not pipeline: the reference repeats stages 1-3 per subject)
        t0 = time.perf_counter()
        for subject in range(1, N_SUBJECTS):
            write_replica_artifacts(feat_root, subject, psd_aggs,
                                    cmc_aggs, channel_suffix)
            rng_s = np.random.default_rng(6000 + subject)
            rep = serial0.copy()
            rep["bpm"] = rep["bpm"] * rng_s.normal(1.0, 0.05)
            rep["hrv"] = rep["hrv"] * rng_s.normal(1.0, 0.1)
            rep["gsr"] = rep["gsr"] + rng_s.normal(0, 0.2)
            out_dir = exp_root / f"subject_{subject:02}" \
                / "serial_measurements"
            rep.to_csv(out_dir / filemgmt.file_title(
                "Enriched Serial Frame", ".csv"))
        stages["synthesis_replicas_sec_host"] = round(
            time.perf_counter() - t0, 2)
        del cmc_results, coh, lo_ci, up_ci, serial0

        # ── stage 4: Combined Statistics frames (4 resolutions × 12) ──
        from mba_tpu.workflows.statistics_data_preparation_workflow \
            import build_combined_statistics_frame
        meter.mark()
        t0 = time.perf_counter()
        frames = {}
        s4_cache: dict = {}       # per-subject invariants shared across
        for n_seg in (1, 2, 5, 10):   # the four segment resolutions
            frames[n_seg] = build_combined_statistics_frame(
                list(range(N_SUBJECTS)), exp_root, feat_root, n_seg,
                music_lookup_table_path=lookup_path,
                input_cache=s4_cache)
        del s4_cache
        stages["s4_stats_frames_sec"] = round(time.perf_counter() - t0, 2)
        compile_split("s4")
        detail["s4_frame_rows"] = {str(k): len(v)
                                   for k, v in frames.items()}
        log(f"[s4] combined frames 1/2/5/10seg × {N_SUBJECTS} subjects "
            f"({[len(v) for v in frames.values()]} rows): "
            f"{stages['s4_stats_frames_sec']}s")

        # ── stage 5: omnibus + CBPA + LOSO + power + report ───────────
        from mba_tpu.workflows.statistics_RQ_A_omnibus_testing_workflow \
            import run_omnibus, RQA_HYPOTHESES, fetch_level_definitions
        from mba_tpu.workflows.statistics_report_workflow import \
            build_report
        from mba_tpu.pipeline import statistical_modelling as statistics
        from mba_tpu.pipeline.cbpa import (CBPAConfig, run_batch,
                                           build_contrast_array,
                                           _build_adjacency)

        out_dir = work / "stats_out"
        t0 = time.perf_counter()
        combined = run_omnibus(
            feat_root, out_dir,
            n_within_trial_segments_list=[1, 2, 5, 10],
            hypotheses=RQA_HYPOTHESES, fdr_levels=(2, 3),
            make_forest_mosaics=True)
        t_omni = time.perf_counter() - t0
        stages["s5_omnibus_sec"] = round(t_omni, 2)
        compile_split("s5_omnibus")
        detail["s5_omnibus_n_hypotheses"] = len(RQA_HYPOTHESES)
        detail["s5_omnibus_n_rows"] = len(combined)
        detail["s5_omnibus_n_models"] = int(
            combined[["Hypothesis", "Comparison_Level", "N. Segments",
                      "Model_Type"]].drop_duplicates().shape[0])

        # GATE G3: the omnibus detected the planted music effect
        lvl0 = combined[
            (combined["Hypothesis"] == "H1: Flexor Beta Peak CMC")
            & (combined["Comparison_Level"].astype(str)
               .str.startswith("Level 0"))
            & (combined["N. Segments"] == 1)
            & (combined["Model_Type"] == "LME")
            & (combined["Parameter"].astype(str).str.contains(
                "Music Listening"))
            & (~combined["Parameter"].astype(str).str.contains(":"))]
        if lvl0.empty:
            raise AssertionError(
                "GATE G3 FAILED: no Level-0 Music Listening row for "
                "CMC_Flexor_max_beta in the omnibus output")
        beta_hat = float(lvl0["Coefficient"].iloc[0])
        p_val = float(lvl0["p_value"].iloc[0])
        gates["g3_music_effect_beta"] = round(beta_hat, 4)
        gates["g3_music_effect_p"] = float(f"{p_val:.2e}")
        if not (beta_hat > 0 and p_val < 0.05):
            raise AssertionError(
                f"GATE G3 FAILED: Level-0 music effect β={beta_hat:.4f},"
                f" p={p_val:.3g} — planted CMC contrast not detected")
        log(f"[gate] G3 omnibus music effect β={beta_hat:.3f}, "
            f"p={p_val:.2e} OK")

        # CBPA through the REAL assembly (stored artifacts → contrast)
        t0 = time.perf_counter()
        cbpa_cfgs = [
            CBPAConfig(modality="CMC", modality_file_id="Flexor",
                       freq_band="beta", condition_A="Happy",
                       condition_B="Silence", n_permutations=1024,
                       tail=1, data_root=work,
                       cmc_time_window_sec=WINDOW_SEC,
                       output_dir=out_dir / "cbpa",
                       hypothesis_label="cbpa_cmc_happy_vs_silence",
                       save_plots=False),
            CBPAConfig(modality="PSD", modality_file_id="eeg",
                       freq_band="alpha", condition_A="Happy",
                       condition_B="Silence", n_permutations=1024,
                       tail=0, data_root=work,
                       psd_time_window_sec=PSD_WINDOW_SEC,
                       output_dir=out_dir / "cbpa",
                       hypothesis_label="cbpa_psd_happy_vs_silence",
                       save_plots=False),
        ]
        cbpa_results, _cbpa_summary = run_batch(cbpa_cfgs)
        t_cbpa = time.perf_counter() - t0
        stages["s5_cbpa_sec"] = round(t_cbpa, 2)
        compile_split("s5_cbpa")

        # GATE G4 + CPU denominator on the CMC contrast
        res = cbpa_results[0]
        n_sig = len(res["good_cluster_inds"])
        gates["g4_cbpa_sig_clusters"] = int(n_sig)
        gates["g4_cbpa_min_p"] = (float(np.min(res["cluster_pv"]))
                                  if len(res["cluster_pv"]) else 1.0)
        if n_sig < 1:
            raise AssertionError(
                "GATE G4 FAILED: CBPA found no significant cluster for "
                "the planted Happy-vs-Silence CMC contrast")
        log(f"[gate] G4 CBPA {n_sig} significant cluster(s), "
            f"min p {gates['g4_cbpa_min_p']:.4f} OK")
        X_cmc, ch_names, time_grid = build_contrast_array(cbpa_cfgs[0])
        adjacency = _build_adjacency(ch_names, X_cmc.shape[1])
        denominators["s5_cbpa_perm_cpu_sec_extrapolated"] = round(
            cpu_cbpa_perm_denominator(
                np.nan_to_num(X_cmc.astype(np.float32)), adjacency,
                res["t_thresh"],
                n_perms_target=sum(c.n_permutations
                                   for c in cbpa_cfgs)), 1)

        # LOSO influence + batched-REML power (reference's optional
        # omnibus arms, :723-775)
        t0 = time.perf_counter()
        statistics.run_influence_analysis(
            [("CMC_Flexor_max_beta", 1, 1), ("CMC_Extensor_max_beta",
                                             1, 1)],
            combined, feat_root, out_dir, fetch_level_definitions)
        detail["s5_loso_sec"] = round(time.perf_counter() - t0, 2)
        t0p = time.perf_counter()
        power_cfg = statistics.PowerConfig(
            dependent_var="CMC_Flexor_max_beta", comp_lvl=1,
            n_segments=1, target_parameters=[], n_simulations=500)
        statistics.run_power_analysis(
            [power_cfg], combined, feat_root, out_dir,
            fetch_level_definitions)
        detail["s5_power_sec"] = round(time.perf_counter() - t0p, 2)
        stages["s5_loso_power_sec"] = round(time.perf_counter() - t0, 2)
        compile_split("s5_loso_power")

        t0 = time.perf_counter()
        report = build_report(out_dir, out_dir, work / "reports",
                              "pipeline_bench")
        stages["s5_report_sec"] = round(time.perf_counter() - t0, 2)
        assert report.exists()
        log(f"[s5] omnibus {t_omni:.1f}s ({detail['s5_omnibus_n_models']}"
            f" model fits), CBPA {t_cbpa:.1f}s, LOSO+power "
            f"{stages['s5_loso_power_sec']}s, report "
            f"{stages['s5_report_sec']}s")

        total = sum(v for k, v in stages.items()
                    if k.endswith("_sec") and not k.startswith("synth"))
        stages["total_pipeline_sec"] = round(total, 2)
        detail["total_compile_sec"] = round(meter.total, 2)
        detail["compilation_cache_dir"] = str(
            jax.config.jax_compilation_cache_dir)
        cpu_total = sum(denominators[k] for k in (
            "s2_filter_cpu_sec_extrapolated",
            "s2_ica_cpu_sec_extrapolated",
            "s3_psd_cpu_sec_extrapolated",
            "s3_cmc_cpu_sec_pinned_rate",
            "s5_cbpa_perm_cpu_sec_extrapolated"))
        denominators["pipeline_cpu_sec_total"] = round(cpu_total, 1)
        result = {
            "description": "five-stage end-to-end pipeline at study "
                           "scale (1 subject heavy stages; 12-subject "
                           "statistics via real loaders on jittered "
                           "lean artifacts) with scientific-correctness"
                           " gates",
            "platform": platform,
            "recording_min": round(rec_sec / 60, 1),
            "task_signal_min": round(S.N_TRIALS * S.TRIAL_SEC / 60, 1),
            "n_eeg": N_EEG, "n_emg": N_EMG, "n_ica_components": N_ICA,
            "n_subjects_statistics": N_SUBJECTS,
            "stages": stages,
            "stage_detail": detail,
            "gates": gates,
            "cpu_denominators": denominators,
            "ica_speedup_vs_cpu": round(
                denominators["s2_ica_cpu_sec_extrapolated"]
                / max(stages["s2_eeg_ica_fit_sec"], 1e-9), 1),
            "pipeline_speedup_vs_cpu": round(
                cpu_total / max(total, 1e-9), 1),
            "measured_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                          time.gmtime()),
        }
        out_path = REPO / "BENCH_PIPELINE.json"
        # preserve blocks other tools merge in (e.g. subject_scaling
        # from tools/bench_subject_scaling.py) — refresh its projection
        # against this run's stage walls
        if out_path.exists():
            prior = json.loads(out_path.read_text())
            for key, val in prior.items():
                if key not in result:
                    result[key] = val
        sc = result.get("subject_scaling")
        if isinstance(sc, dict):
            heavy_wall = sum(stages[k] for k in stages
                             if k.startswith(("s1_", "s2_", "s3_"))
                             and k.endswith("_sec"))
            heavy_compile = sum(v for k, v in detail.items()
                                if k.startswith(("s1_", "s2_", "s3_"))
                                and k.endswith("_compile_sec"))
            stats_wall = sum(stages[k] for k in stages
                             if k.startswith(("s4_", "s5_"))
                             and k.endswith("_sec"))
            dev_12 = ((heavy_wall - heavy_compile) * N_SUBJECTS
                      + heavy_compile + stats_wall)
            cpu_12 = N_SUBJECTS * sum(denominators[k] for k in (
                "s2_filter_cpu_sec_extrapolated",
                "s2_ica_cpu_sec_extrapolated",
                "s3_psd_cpu_sec_extrapolated",
                "s3_cmc_cpu_sec_pinned_rate")) \
                + denominators["s5_cbpa_perm_cpu_sec_extrapolated"]
            sc["full_scale_heavy_wall_sec_1subj"] = round(heavy_wall, 1)
            sc["full_scale_heavy_compile_sec"] = round(heavy_compile, 1)
            sc["pipeline_12subj_device_sec_extrapolated"] = round(dev_12, 1)
            sc["pipeline_12subj_cpu_sec_extrapolated"] = round(cpu_12, 1)
            sc["pipeline_speedup_12subj_measured_scaling"] = round(
                cpu_12 / dev_12, 1)
        out_path.write_text(json.dumps(result, indent=2) + "\n")
        log(f"[done] total pipeline {total:.1f}s (CPU denominator "
            f"{cpu_total:.0f}s ⇒ ×{result['pipeline_speedup_vs_cpu']}) "
            f"→ {out_path}")
        print(json.dumps(result))
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
