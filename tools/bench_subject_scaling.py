"""Measured per-subject scaling of the heavy pipeline stages.

The five-stage pipeline benchmark (``tools/bench_pipeline.py``) runs
stages 1-3 on ONE heavy subject at the study's true recording length and
extrapolates the reference's per-subject loop linearly in subject count
(the reference repeats stages 1-3 per subject —
reference ``src/subject_feature_extraction_workflow.py:37``).  That
linearity has never been *measured*: per-subject fixed costs (compile,
host GC, growing caches) would be invisible to a
single-subject run.

This tool runs stages 1-3 — otb4 import, the full EEG preprocessing
cascade incl. ICA + labelling, both EMG cascades, PSD band-aggregates
for all three montages, task-wise jackknifed CMC for both muscles, and
the enriched serial frame — for ALL 12 subjects, each with its own
synthesized raw signals, at a reduced recording length (default 10
trials ≈ 9.5 min vs the study's 30 ≈ 28.4 min; identical per-window
shapes, fewer windows).  It records per-subject wall and compile
seconds, checks the marginal cost is flat (subjects 1-11 after the
subject-0 compile), and merges a ``subject_scaling`` block into
``BENCH_PIPELINE.json`` with an updated whole-pipeline x-number that
multiplies the *measured* full-scale heavy-stage cost by 12 subjects
(compile counted once) instead of assuming it.

Run: ``python tools/bench_subject_scaling.py [n_trials]``
"""
from __future__ import annotations

import gc
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
from bench_pipeline import (CompileMeter,  # noqa: E402
                            FS, N_ICA, WINDOW_SEC, PSD_WINDOW_SEC,
                            N_SUBJECTS, log)


def run_subject(subject: int, plan: S.TrialPlan, work: Path,
                meter: CompileMeter) -> dict:
    """Stages 1-3 for one subject, timed.  Mirrors the heavy-subject
    path of ``bench_pipeline.main`` (same production entry points)."""
    import jax
    from mba_tpu.io.otb4 import write_otb4, read_otb4
    from mba_tpu.utils.transfer import upload_counts, upload_quantized
    from mba_tpu.pipeline.preprocessing import BiosignalPreprocessor
    from mba_tpu.pipeline import signal_features as features
    from mba_tpu.pipeline import data_integration as di
    from mba_tpu.pipeline import data_analysis
    from mba_tpu.pipeline.cbpa import CMC_EEG_CHANNEL_SUBSET
    from mba_tpu.workflows.subject_feature_extraction_workflow import \
        build_enriched_serial_frame

    exp_root = work / "data" / "experiment_results"
    feat_root = work / "data" / "precomputed_features"
    sub_exp = exp_root / f"subject_{subject:02}"
    sub_feat = feat_root / f"subject_{subject:02}"
    sub_feat.mkdir(parents=True, exist_ok=True)

    rec = {"subject": subject}
    eeg, emg1, emg2 = S.synth_subject(plan, seed=100 + subject)
    S.write_subject_tree(exp_root, subject, plan, write_raw_serial=True)
    # stage-1 inputs (the otb4 archives the acquisition stage would
    # have written; authoring them is synthesis, reading is pipeline)
    p1 = work / f"emg_flexor_{subject:02}.otb4"
    p2 = work / f"emg_extensor_{subject:02}.otb4"
    write_otb4(p1, emg1.T, FS)
    write_otb4(p2, emg2.T, FS)
    del emg1, emg2

    meter.mark()
    t_subj = time.perf_counter()

    # ── stage 1: otb4 import ──────────────────────────────────────────
    r1 = read_otb4(p1, raw_counts=True)
    r2 = read_otb4(p2, raw_counts=True)
    emg1_counts = r1["signals"][0][1].T
    emg2_counts = r2["signals"][0][1].T

    # ── stage 2: EEG cascade incl. ICA, then both EMG cascades ───────
    t0 = time.perf_counter()
    eeg_d, up_bytes, _ = upload_quantized(eeg, np.int16)
    jax.block_until_ready(eeg_d)
    rec["upload_sec"] = round(time.perf_counter() - t0, 2)
    rec["upload_bytes"] = int(up_bytes)
    del eeg
    prep = BiosignalPreprocessor(
        eeg_d, int(FS), "eeg", n_ica_components=N_ICA,
        automatic_ic_labelling=True, wavelet_type=None,
        amplitude_rejection_threshold=3.0, device_resident=True)
    t0 = time.perf_counter()
    eeg_clean = prep.np_output_data
    jax.block_until_ready(eeg_clean)
    rec["eeg_cascade_sec"] = round(time.perf_counter() - t0, 2)
    rec["ica_n_iter"] = int(prep.ica_result.n_iter_)
    prep.free_intermediate_stages()
    del prep

    t0 = time.perf_counter()
    emg_clean = {}
    for muscle, counts, vpc in (("flexor", emg1_counts,
                                 r1["mv_per_count"][0]),
                                ("extensor", emg2_counts,
                                 r2["mv_per_count"][0])):
        d, nb = upload_counts(counts, vpc[None, :])
        emg_clean[muscle] = BiosignalPreprocessor(
            d, int(FS), "emg", n_ica_components=None,
            automatic_ic_labelling=False, wavelet_type=None,
            laplacian_filter_neighbor_radius=None,
            amplitude_rejection_threshold=3.0,
            device_resident=True).np_output_data
        rec["upload_bytes"] += int(nb)
    jax.block_until_ready(emg_clean)
    rec["emg_cascades_sec"] = round(time.perf_counter() - t0, 2)
    del emg1_counts, emg2_counts, r1, r2

    # ── stage 3: PSD band-aggregates + task CMC + serial frame ───────
    log_df = di.fetch_enriched_log_frame(sub_exp, verbose=False)
    log_df.index = data_analysis.make_timezone_aware(log_df.index)

    t0 = time.perf_counter()
    for modality, arr in (("eeg", eeg_clean),
                          ("emg_1_flexor", emg_clean["flexor"]),
                          ("emg_2_extensor", emg_clean["extensor"])):
        s_dev, tc_, fr_ = features.multitaper_psd(
            arr, FS, nw=3, window_length_sec=PSD_WINDOW_SEC,
            overlap_frac=0.5, axis=0, apply_log_scale=True,
            device_output=True)
        payload_dev, names, edges = \
            features.band_aggregate_spectrogram(s_dev, fr_)
        payload = np.asarray(payload_dev, dtype=np.float32)
        features.save_band_aggregates(payload, tc_, names, edges,
                                      "PSD", sub_feat,
                                      identifier_suffix=modality)
        del s_dev, payload_dev
    rec["psd_sec"] = round(time.perf_counter() - t0, 2)

    t0 = time.perf_counter()
    n_active = 0
    channel_suffix = f"Channels_{'_'.join(CMC_EEG_CHANNEL_SUBSET)}"
    for muscle in ("flexor", "extensor"):
        coh, lo, up, tc_c, fr_c = features.compute_task_wise_aggregated_cmc(
            eeg_clean, emg_clean[muscle], int(FS), muscle_group=muscle,
            log_frame=log_df, eeg_channel_subset=CMC_EEG_CHANNEL_SUBSET,
            window_size_sec=WINDOW_SEC, window_overlap_ratio=0.5,
            use_jackknife=True, save_dir=sub_feat,
            transfer_dtype=np.int8, freq_range=(0.0, 250.0))
        n_active = int((coh.sum(axis=(1, 2)) != 0).sum())
        payload, names, edges = features.band_aggregate_spectrogram(
            coh, fr_c)
        features.save_band_aggregates(
            payload, tc_c, names, edges, "CMC", sub_feat,
            identifier_suffix=(f"{muscle.capitalize()} Trial-wise "
                               f"{channel_suffix}"))
        del coh, lo, up
    rec["cmc_sec"] = round(time.perf_counter() - t0, 2)
    rec["cmc_active_windows"] = n_active
    assert n_active > 0, f"subject {subject}: no active CMC windows"

    t0 = time.perf_counter()
    build_enriched_serial_frame(sub_exp)
    rec["serial_sec"] = round(time.perf_counter() - t0, 2)

    rec["wall_sec"] = round(time.perf_counter() - t_subj, 2)
    rec["compile_sec"] = meter.since_mark()
    del eeg_clean, emg_clean
    p1.unlink()
    p2.unlink()
    gc.collect()
    return rec


def main():
    n_trials = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    import jax
    plan = S.TrialPlan(n_trials=n_trials)
    meter = CompileMeter()
    work = Path(tempfile.mkdtemp(prefix="bench_scaling_"))
    platform = jax.devices()[0].platform
    log(f"[scaling] {N_SUBJECTS} subjects × {plan.rec_sec/60:.1f} min "
        f"({n_trials} trials) on {platform}")
    subjects = []
    try:
        for s in range(N_SUBJECTS):
            rec = run_subject(s, plan, work, meter)
            subjects.append(rec)
            log(f"[scaling] subject {s:02}: wall {rec['wall_sec']}s "
                f"(compile {rec['compile_sec']}s, upload "
                f"{rec['upload_sec']}s, eeg {rec['eeg_cascade_sec']}s, "
                f"emg {rec['emg_cascades_sec']}s, psd {rec['psd_sec']}s,"
                f" cmc {rec['cmc_sec']}s, {rec['cmc_active_windows']} "
                f"active windows)")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    walls = np.array([r["wall_sec"] for r in subjects])
    steady = walls[1:]                       # subject 0 carries compile
    idx = np.arange(1, N_SUBJECTS, dtype=np.float64)
    slope, intercept = np.polyfit(idx, np.cumsum(steady), 1)[:2]
    marginal_med = float(np.median(steady))
    spread = float((steady.max() - steady.min()) / marginal_med)
    block = {
        "description": "stages 1-3 run for ALL 12 subjects at reduced "
                       "recording length — measures the "
                       "per-subject marginal cost the whole-pipeline "
                       "x-number extrapolates",
        "platform": platform,
        "n_trials": n_trials,
        "recording_min_per_subject": round(plan.rec_sec / 60, 2),
        "per_subject": subjects,
        "subject0_wall_sec": float(walls[0]),
        "marginal_median_sec": round(marginal_med, 2),
        "marginal_fit_slope_sec_per_subject": round(float(slope), 2),
        "marginal_rel_spread": round(spread, 3),
        "total_wall_sec": round(float(walls.sum()), 2),
        "measured_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                      time.gmtime()),
    }

    # merge into BENCH_PIPELINE.json and recompute the 12-subject
    # whole-pipeline number from MEASURED quantities: full-scale heavy
    # stages × 12 (compile once — justified by the flat marginal cost
    # measured above), statistics stages as measured.
    bp_path = REPO / "BENCH_PIPELINE.json"
    if bp_path.exists():
        bp = json.loads(bp_path.read_text())
        st, dt = bp["stages"], bp["stage_detail"]
        heavy_keys = [k for k in st
                      if k.startswith(("s1_", "s2_", "s3_"))
                      and k.endswith("_sec")]
        heavy_wall = sum(st[k] for k in heavy_keys)
        heavy_compile = sum(v for k, v in dt.items()
                            if k.startswith(("s1_", "s2_", "s3_"))
                            and k.endswith("_compile_sec"))
        stats_wall = sum(st[k] for k in st
                         if k.startswith(("s4_", "s5_"))
                         and k.endswith("_sec"))
        dev_12 = (heavy_wall - heavy_compile) * N_SUBJECTS \
            + heavy_compile + stats_wall
        den = bp["cpu_denominators"]
        cpu_12 = N_SUBJECTS * sum(den[k] for k in (
            "s2_filter_cpu_sec_extrapolated",
            "s2_ica_cpu_sec_extrapolated",
            "s3_psd_cpu_sec_extrapolated",
            "s3_cmc_cpu_sec_pinned_rate")) \
            + den["s5_cbpa_perm_cpu_sec_extrapolated"]
        block["full_scale_heavy_wall_sec_1subj"] = round(heavy_wall, 1)
        block["full_scale_heavy_compile_sec"] = round(heavy_compile, 1)
        block["pipeline_12subj_device_sec_extrapolated"] = round(dev_12, 1)
        block["pipeline_12subj_cpu_sec_extrapolated"] = round(cpu_12, 1)
        block["pipeline_speedup_12subj_measured_scaling"] = round(
            cpu_12 / dev_12, 1)
        bp["subject_scaling"] = block
        bp_path.write_text(json.dumps(bp, indent=2) + "\n")
        log(f"[scaling] marginal {marginal_med:.1f}s/subject "
            f"(spread {spread:.1%}), 12-subject pipeline "
            f"{dev_12:.0f}s vs CPU {cpu_12:.0f}s ⇒ "
            f"×{block['pipeline_speedup_12subj_measured_scaling']} "
            f"→ merged into {bp_path.name}")
    print(json.dumps(block))


if __name__ == "__main__":
    main()
