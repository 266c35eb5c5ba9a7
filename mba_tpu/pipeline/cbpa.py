"""Cluster-Based Permutation Analysis (post-hoc spatio-temporal tests).

Parity target: reference ``src/pipeline/cbpa.py`` (1251 LoC) — the
RQ-A post-hoc decomposition: per-subject A−B band-power contrasts on a
common within-trial time grid (or force-cycle phase grid), Delaunay
spatio-temporal adjacency, and a cluster-based sign-flip permutation test.
MNE's joblib permutation loop is replaced by
:mod:`mba_tpu.ops.permutation` — all permutations batched on device.

Key symbols (reference line refs):
- :class:`CBPAConfig`            ↔ :50-193
- adjacency construction         ↔ :200-243, :949-982
- :func:`load_stats_frame` / :func:`get_trial_condition_map` ↔ :445-529
- :func:`build_contrast_array`   ↔ :733-942
- :func:`run_cbpa`               ↔ :985-1067
- :func:`_save_results`          ↔ :1076-1185
- :func:`run_batch`              ↔ :1214-1250
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Literal, Optional

import numpy as np
import pandas as pd
from scipy.stats import t as t_dist

from mba_tpu.channel_layout import EEG_CHANNELS, EEG_CHANNEL_IND_DICT
from mba_tpu.ops.permutation import (cluster_permutation_1samp_test,
                                     delaunay_channel_adjacency,
                                     combine_adjacency, add_phase_wraparound)
from mba_tpu.pipeline.signal_features import (BandAggregates,
                                              fetch_band_aggregates,
                                              fetch_stored_spectrograms,
                                              aggregate_psd_spectrogram,
                                              mirror_eeg_channel_list)
from mba_tpu.pipeline import data_integration
from mba_tpu.pipeline import data_analysis
from mba_tpu.utils import file_management as filemgmt

EEG_SFREQ: float = 2048.0

# 11 left-hemisphere motor channels (mirrored for left-handers)
CMC_EEG_CHANNEL_SUBSET: list[str] = [
    "C5", "C3", "C1",
    "FC5", "FC3", "FC1", "F3",
    "CP5", "CP3", "CP1", "P3",
]
CMC_CHANNEL_FILE_SUFFIX: str = f"Channels_{'_'.join(CMC_EEG_CHANNEL_SUBSET)}"

STATS_FRAME_SEG_SUFFIX: str = "1seg"


@dataclass
class CBPAConfig:
    """Full specification of one CBPA run (reference cbpa.py:50-193)."""
    # Feature
    modality: Literal["PSD", "CMC"] = "PSD"
    modality_file_id: str = "eeg"
    freq_band: str = "alpha"
    channels: Optional[list[str]] = None
    # Contrast
    condition_column: str = "Category or Silence"
    condition_A: str = "Happy"
    condition_B: str = "Silence"
    # Segmentation
    n_within_trial_segs: int = 1
    exclude_subjects: list[int] | None = None
    # CBPA
    alpha_cluster_forming: float = 0.05
    n_permutations: int = 1000
    tail: Literal[-1, 0, 1] = 0
    use_spatio_temporal: bool = True
    n_jobs: int = -1          # kept for API parity; device batching ignores
    seed: int = 42
    # I/O
    data_root: Path = field(default_factory=lambda: Path().resolve().parent)
    psd_time_window_sec: float = 0.25
    cmc_time_window_sec: float = 2.0
    overlap_ratio: float = .5
    # trial-span timing (reference get_task_start_end defaults)
    task_latency_assumption_sec: float = 3.25
    task_end_cutoff_sec: float = 2.0
    psd_is_log_scaled: bool = True
    output_dir: Path = field(
        default_factory=lambda: Path().resolve().parent / "output"
        / "statistics_post_hoc_testing")
    hypothesis_label: str = "cbpa_run"
    save_plots: bool = True
    show_plots: bool = False
    # Phase normalisation (CMC only)
    use_phase_normalization: bool = False
    n_phase_bins: int = 36
    min_samples_per_cycle: int = 2
    min_cycles_per_condition: int = 3
    # Target-sine subplot passthroughs (used by visualization)
    show_target_sine: bool | None = None
    target_sine_min_pct_mvc: float = 7.5
    target_sine_max_pct_mvc: float = 22.5
    target_sine_frequency_hz: float = 0.1
    include_dynamometer_force: bool = True
    phase_start_offset_sec: float | None = None
    force_phase_start_offset_sec: float | None = None
    include_suptitle: bool = False
    use_stretched_window_timestamps: bool = False


# ══════════════════════════════════════════════════════════════════════
#  adjacency
# ══════════════════════════════════════════════════════════════════════
def _build_adjacency(ch_names: list[str], n_times: int):
    """Delaunay spatial × temporal-chain adjacency (reference :224-243)."""
    spatial = delaunay_channel_adjacency(ch_names)
    combined = combine_adjacency(n_times, spatial)
    print(f"  [adjacency] spatial: {spatial.shape}, combined: "
          f"{combined.shape}, nnz edges: {combined.nnz}")
    return combined


# ══════════════════════════════════════════════════════════════════════
#  data loading
# ══════════════════════════════════════════════════════════════════════
def _get_task_freq_for_trial(log_df: pd.DataFrame, t_start, t_end
                             ) -> float | None:
    mask = (log_df.index >= t_start) & (log_df.index < t_end)
    col = log_df.loc[mask, "Task Frequency"].dropna()
    if col.empty:
        return None
    return float(pd.to_numeric(col).mode().iloc[0])


def _load_subject_data(cfg: CBPAConfig, subject_ind: int):
    """Spectrogram + enriched log for one subject (reference :282-350)."""
    DATA = Path(cfg.data_root) / "data"
    subject_feat_dir = (DATA / "precomputed_features"
                        / f"subject_{subject_ind:02}")
    subject_exp_dir = (DATA / "experiment_results"
                       / f"subject_{subject_ind:02}")

    handedness = data_integration.fetch_personal_data(
        subject_exp_dir, False)['Dominant hand']
    log_df = data_integration.fetch_enriched_log_frame(subject_exp_dir,
                                                       verbose=False)
    log_df.index = data_analysis.make_timezone_aware(log_df.index)
    qtc_start, qtc_end = data_integration.get_qtc_measurement_start_end(
        log_df, False)

    if cfg.modality == "CMC":
        subset = (mirror_eeg_channel_list(CMC_EEG_CHANNEL_SUBSET,
                                          input_is_left=True)
                  if handedness == 'Left' else CMC_EEG_CHANNEL_SUBSET)
        file_id = [cfg.modality_file_id, f"Channels_{'_'.join(subset)}"]
        expected_ch = len(CMC_EEG_CHANNEL_SUBSET)
    else:
        file_id = cfg.modality_file_id
        expected_ch = None

    try:
        spectrogram, times, freqs = fetch_stored_spectrograms(
            subject_feat_dir, modality=cfg.modality,
            file_identifier=file_id, expected_n_channels=expected_ch)
    except (ValueError, FileNotFoundError):
        # lean feature store: a band-aggregate artifact (the device-first
        # alternative to the full grid, signal_features.BandAggregates)
        # carries exactly the per-(window, channel) band values
        # _extract_band_power would reduce the grid to
        agg = fetch_band_aggregates(subject_feat_dir, cfg.modality,
                                    file_identifier=file_id)
        if expected_ch is not None and agg.n_channels != expected_ch:
            raise ValueError(
                f"Band-aggregate artifact has {agg.n_channels} channels, "
                f"expected {expected_ch} (modality={cfg.modality!r}, "
                f"file_identifier={file_id!r}).")
        if cfg.freq_band not in agg.band_names:
            # fail at load time with the remedy, not deep inside
            # _extract_band_power: a lean artifact saved at low fs can
            # lack high bands, and no full-grid fallback exists here
            # (fetch_stored_spectrograms already failed above)
            raise ValueError(
                f"[CBPA] Band-aggregate artifact for subject dir "
                f"{subject_feat_dir} lacks band {cfg.freq_band!r} "
                f"(stored: {agg.band_names}) and no full-grid "
                f"spectrogram is on disk — re-run feature extraction "
                f"with the full grid or with this band included.")
        spectrogram, times, freqs = agg, agg.time_centers, None

    times_arr = np.asarray(times, dtype=np.float64)
    if cfg.use_stretched_window_timestamps:
        half = 0.5 * (cfg.cmc_time_window_sec if cfg.modality == "CMC"
                      else cfg.psd_time_window_sec)
        timestamps = data_analysis.add_time_index(
            start_timestamp=qtc_start + pd.Timedelta(seconds=half),
            end_timestamp=qtc_end - pd.Timedelta(seconds=half),
            n_timesteps=len(times_arr))
    else:
        timestamps = pd.DatetimeIndex([
            qtc_start + pd.Timedelta(seconds=float(sec))
            if np.isfinite(sec) else pd.NaT for sec in times_arr])
    timestamps = data_analysis.make_timezone_aware(timestamps)
    return spectrogram, freqs, timestamps, log_df


def _get_trial_spans(log_df: pd.DataFrame,
                     cfg: "CBPAConfig | None" = None) -> dict:
    kwargs = {}
    if cfg is not None:
        kwargs = dict(
            assumed_latency_sec=cfg.task_latency_assumption_sec,
            cut_off_sec_to_prevent_transients=cfg.task_end_cutoff_sec)
    return data_integration.get_all_task_start_ends(log_df, "dict",
                                                    **kwargs)


def _common_time_grid_from_spans(cfg: CBPAConfig, trial_spans: dict,
                                 overlap_ratio=.5) -> np.ndarray:
    tw = (cfg.psd_time_window_sec if cfg.modality == "PSD"
          else cfg.cmc_time_window_sec)
    first_start, first_end = next(iter(trial_spans.values()))
    dur = (pd.Timestamp(first_end)
           - pd.Timestamp(first_start)).total_seconds()
    n_times = max(1, int(dur / (tw * overlap_ratio)))
    return np.arange(n_times) * (tw * overlap_ratio)


def load_stats_frame(data_root: Path) -> pd.DataFrame:
    """Authoritative trial-condition labels (reference :445-492)."""
    feature_dir = Path(data_root) / "data" / "precomputed_features"
    try:
        csv_path = filemgmt.most_recent_file(
            feature_dir, ".csv",
            [f"Combined Statistics {STATS_FRAME_SEG_SUFFIX}"])
    except (ValueError, FileNotFoundError):
        raise FileNotFoundError(
            f"[CBPA] Required statistics frame not found in {feature_dir} "
            f"(expected 'Combined Statistics {STATS_FRAME_SEG_SUFFIX}'). "
            f"Run the statistics-data-preparation workflow first.")
    df = pd.read_csv(csv_path)
    required = {"Subject ID", "Trial ID", "Category or Silence",
                "Perceived Category", "Music Listening"}
    missing = required - set(df.columns)
    if missing:
        raise ValueError(
            f"[CBPA] Statistics frame is missing required columns: "
            f"{missing}")
    return df


def get_trial_condition_map(stats_df: pd.DataFrame, subject_id: int,
                            condition_column: str) -> dict:
    subj = stats_df[stats_df["Subject ID"] == subject_id]
    if subj.empty:
        raise ValueError(
            f"[CBPA] Subject {subject_id} not found in statistics frame.")
    out = {}
    for _, row in subj.iterrows():
        val = row.get(condition_column, None)
        out[int(row["Trial ID"])] = None if pd.isna(val) else str(val)
    return out


# ══════════════════════════════════════════════════════════════════════
#  band-power extraction & per-trial/per-phase resampling
# ══════════════════════════════════════════════════════════════════════
def _extract_band_power(cfg: CBPAConfig, spectrogram: np.ndarray,
                        freqs: np.ndarray,
                        channel_indices: list[int] | None,
                        freq_pooling: str = "max",
                        channel_pooling: str = "max") -> np.ndarray:
    """Band-reduce spectrogram → (n_windows, n_channels) (ref :564-649)."""
    if isinstance(spectrogram, BandAggregates):
        # lean artifact: band values are pre-reduced on-device with the
        # same inclusive band bins; CMC aggregates are stored EMG-pooled
        stat = freq_pooling if cfg.modality == "CMC" else "mean"
        return spectrogram.select(cfg.freq_band, stat,
                                  channel_indices=channel_indices)
    spec = spectrogram
    if cfg.modality == "CMC":
        if spec.ndim == 4:
            spec = (np.nanmean(spec, axis=3) if channel_pooling == "mean"
                    else np.nanmax(spec, axis=3))
        elif spec.ndim != 3:
            raise ValueError(
                f"Unexpected CMC spectrogram shape {spec.shape}.")
    elif spec.ndim != 3:
        raise ValueError(f"Unexpected PSD spectrogram shape {spec.shape}.")
    band_op = freq_pooling if cfg.modality == "CMC" else "mean"
    return aggregate_psd_spectrogram(
        spec, freqs, normalize_mvc=False, channel_indices=channel_indices,
        is_log_scaled=(cfg.psd_is_log_scaled if cfg.modality == "PSD"
                       else False),
        freq_slice=cfg.freq_band, aggregation_ops=[(band_op, 1)])


def _band_power_per_trial(cfg: CBPAConfig, band_power: np.ndarray,
                          timestamps: pd.DatetimeIndex,
                          trial_spans: dict,
                          target_n_times: int | None):
    """Per-trial series resampled to a common grid (reference :381-432)."""
    slices, ids_out, lengths = [], [], []
    for trial_id, (t_start, t_end) in trial_spans.items():
        mask = (timestamps >= t_start) & (timestamps < t_end)
        slc = band_power[np.asarray(mask)]
        if slc.shape[0] == 0:
            warnings.warn(f"Trial {trial_id}: no spectrogram windows in "
                          f"span. Skipping.")
            continue
        slices.append(slc)
        ids_out.append(trial_id)
        lengths.append(slc.shape[0])
    if not slices:
        raise RuntimeError(
            "No trial windows found — check timestamp alignment.")
    if target_n_times is None:
        target_n_times = int(pd.Series(lengths).mode().iloc[0])
    n_ch = slices[0].shape[-1]
    out = np.full((len(slices), target_n_times, n_ch), np.nan)
    for i, slc in enumerate(slices):
        if slc.shape[0] == target_n_times:
            out[i] = slc
        else:
            src = np.linspace(0, 1, slc.shape[0])
            dst = np.linspace(0, 1, target_n_times)
            for ch in range(n_ch):
                out[i, :, ch] = np.interp(dst, src, slc[:, ch])
    return out, ids_out


def _band_power_per_phase(cfg: CBPAConfig, band_power: np.ndarray,
                          timestamps: pd.DatetimeIndex,
                          trial_spans: dict, trial_cond_map: dict,
                          log_df: pd.DataFrame,
                          min_cycle_coverage_ratio: float = 0.8) -> dict:
    """Cycle-wise phase-normalised profiles per condition (ref :651-725)."""
    phase_grid = np.linspace(0, 360, cfg.n_phase_bins, endpoint=False)
    by_cond: dict[str, list[np.ndarray]] = {}
    for trial_id, (t_start, t_end) in trial_spans.items():
        condition = trial_cond_map.get(int(trial_id))
        if condition is None:
            continue
        task_freq = _get_task_freq_for_trial(log_df, t_start, t_end)
        if task_freq is None or task_freq <= 0:
            warnings.warn(f"[phase] Trial {trial_id}: Task Frequency "
                          f"missing or zero. Skipping.")
            continue
        tw_step = (cfg.cmc_time_window_sec if cfg.modality == "CMC"
                   else cfg.psd_time_window_sec) * (1 - cfg.overlap_ratio)
        if (1.0 / task_freq) / tw_step < cfg.min_samples_per_cycle:
            warnings.warn(f"[phase] Trial {trial_id}: too few samples per "
                          f"cycle at {task_freq} Hz — skipping.")
            continue
        mask = np.asarray((timestamps >= t_start) & (timestamps < t_end))
        trial_bp = band_power[mask]
        trial_ts = timestamps[mask]
        if len(trial_ts) == 0:
            continue
        t_rel = np.array([(ts - t_start).total_seconds()
                          for ts in trial_ts])
        phase_offset = (float(cfg.phase_start_offset_sec)
                        if cfg.phase_start_offset_sec is not None
                        else float(1.0 / task_freq))
        cycles = data_analysis.phase_normalize_cycles(
            signal=trial_bp, t_rel=t_rel, task_freq=task_freq,
            trial_dur_sec=(t_end - t_start).total_seconds(),
            phase_grid=phase_grid,
            min_samples_per_cycle=cfg.min_samples_per_cycle,
            min_cycle_coverage_ratio=min_cycle_coverage_ratio,
            start_offset_sec=phase_offset, verbose=False)
        for profile in cycles:
            by_cond.setdefault(condition, []).append(profile)
    return by_cond


# ══════════════════════════════════════════════════════════════════════
#  contrast array
# ══════════════════════════════════════════════════════════════════════
def build_contrast_array(cfg: CBPAConfig):
    """X: (n_subjects, n_times, n_channels) A−B contrast (ref :733-942)."""
    stats_df = load_stats_frame(cfg.data_root)
    valid_ids = sorted(stats_df["Subject ID"].astype(int).unique())
    if cfg.exclude_subjects:
        valid_ids = [s for s in valid_ids
                     if s not in cfg.exclude_subjects]
    print(f"  [subjects] Running on {len(valid_ids)} subjects: "
          f"{valid_ids}")

    if cfg.modality == "CMC":
        ch_indices = None
        ch_names_out = (cfg.channels if cfg.channels is not None
                        else CMC_EEG_CHANNEL_SUBSET)
    else:
        if cfg.channels is not None:
            ch_indices = [EEG_CHANNEL_IND_DICT[ch] for ch in cfg.channels]
            ch_names_out = cfg.channels
        else:
            ch_indices = None
            ch_names_out = EEG_CHANNELS

    time_grid = None
    n_times_ref = None
    if cfg.use_phase_normalization:
        time_grid = np.linspace(0, 360, cfg.n_phase_bins, endpoint=False)
        n_times_ref = cfg.n_phase_bins

    diffs = []
    for subj in valid_ids:
        try:
            spectrogram, freqs, timestamps, log_df = _load_subject_data(
                cfg, subj)
        except Exception as exc:
            warnings.warn(f"Subject {subj:02}: load failed ({exc}). "
                          f"Skipping.")
            continue
        try:
            trial_cond_map = get_trial_condition_map(
                stats_df, subj, cfg.condition_column)
        except ValueError as exc:
            warnings.warn(str(exc) + " Skipping.")
            continue
        trial_spans = {int(k): v
                       for k, v in _get_trial_spans(log_df, cfg).items()}
        if time_grid is None:
            time_grid = _common_time_grid_from_spans(
                cfg, trial_spans, overlap_ratio=cfg.overlap_ratio)
            n_times_ref = len(time_grid)

        band_power = _extract_band_power(cfg, spectrogram, freqs,
                                         ch_indices)

        if cfg.use_phase_normalization:
            by_cond = _band_power_per_phase(cfg, band_power, timestamps,
                                            trial_spans, trial_cond_map,
                                            log_df)
            cyc_a = by_cond.get(cfg.condition_A, [])
            cyc_b = by_cond.get(cfg.condition_B, [])
            if (len(cyc_a) < cfg.min_cycles_per_condition
                    or len(cyc_b) < cfg.min_cycles_per_condition):
                warnings.warn(f"Subject {subj:02}: too few valid cycles. "
                              f"Skipping.")
                continue
            mean_a = np.nanmean(np.stack(cyc_a, axis=0), axis=0)
            mean_b = np.nanmean(np.stack(cyc_b, axis=0), axis=0)
            diffs.append(mean_a - mean_b)
            continue

        trial_data, trial_ids_used = _band_power_per_trial(
            cfg, band_power, timestamps, trial_spans, n_times_ref)
        idx_a = [i for i, tid in enumerate(trial_ids_used)
                 if trial_cond_map.get(tid) == cfg.condition_A]
        idx_b = [i for i, tid in enumerate(trial_ids_used)
                 if trial_cond_map.get(tid) == cfg.condition_B]
        if not idx_a or not idx_b:
            warnings.warn(f"Subject {subj:02}: missing trials for one "
                          f"condition. Skipping.")
            continue
        mean_a = np.nanmean(trial_data[idx_a], axis=0)
        mean_b = np.nanmean(trial_data[idx_b], axis=0)
        diffs.append(mean_a - mean_b)

    if not diffs:
        raise RuntimeError(
            "[CBPA] No valid subjects produced a contrast.")
    X = np.stack(diffs, axis=0)
    print(f"  Contrast array built: {X.shape}")
    return X, ch_names_out, time_grid


# ══════════════════════════════════════════════════════════════════════
#  runner
# ══════════════════════════════════════════════════════════════════════
def run_cbpa(cfg: CBPAConfig,
             cluster_rows_accumulator: list | None = None,
             X: np.ndarray | None = None,
             ch_names: list[str] | None = None,
             time_grid: np.ndarray | None = None) -> dict:
    """Full CBPA pipeline for one contrast configuration (ref :985-1067).

    ``X``/``ch_names``/``time_grid`` may be passed directly (testing,
    custom assembly); otherwise they are built from the artifact store.
    """
    filemgmt.assert_dir(cfg.output_dir)
    if X is None:
        X, ch_names, time_grid = build_contrast_array(cfg)
    n_subj, n_times, n_ch = X.shape

    df_stat = n_subj - 1
    q = (1 - cfg.alpha_cluster_forming / 2 if cfg.tail == 0
         else 1 - cfg.alpha_cluster_forming)
    t_thresh = float(t_dist.ppf(q, df=df_stat))
    print(f"  Cluster-forming threshold t({df_stat}) = ±{t_thresh:.4f} "
          f"(alpha={cfg.alpha_cluster_forming}, tail={cfg.tail})")

    adjacency = _build_adjacency(ch_names, n_times)
    if cfg.use_phase_normalization:
        adjacency = add_phase_wraparound(adjacency, n_times, n_ch)
        print(f"  [adjacency] Phase wrap-around edges added")

    # NaNs (subjects with partial coverage) are zeroed: a zero contributes
    # no contrast evidence, matching MNE's requirement of finite input
    X = np.nan_to_num(np.asarray(X, np.float32))

    t_obs, clusters, cluster_pv, H0 = cluster_permutation_1samp_test(
        X, adjacency, n_permutations=cfg.n_permutations,
        threshold=t_thresh, tail=cfg.tail, seed=cfg.seed,
        permutation_chunk=min(cfg.n_permutations, 256))

    alpha_cbpa = 0.05
    good_cluster_inds = np.where(np.asarray(cluster_pv) < alpha_cbpa)[0]
    print(f"  Clusters found: {len(clusters)} total, "
          f"{len(good_cluster_inds)} significant (cluster p < "
          f"{alpha_cbpa})")

    results = dict(t_obs=t_obs, t_thresh=t_thresh, clusters=clusters,
                   cluster_pv=np.asarray(cluster_pv), H0=H0,
                   good_cluster_inds=good_cluster_inds,
                   ch_names=ch_names, time_grid=time_grid, cfg=cfg,
                   n_valid_subjects=n_subj)
    _save_results(results, cfg,
                  cluster_rows_accumulator=cluster_rows_accumulator,
                  save_per_run_cluster_csv=(cluster_rows_accumulator
                                            is None))
    if cfg.save_plots or cfg.show_plots:
        try:
            from mba_tpu.pipeline import visualizations
            visualizations.plot_cbpa_results(results, cfg)
        except Exception as exc:
            warnings.warn(f"CBPA plotting skipped: {exc}")
    return results


def _save_results(results: dict, cfg: CBPAConfig,
                  cluster_rows_accumulator: list | None = None,
                  save_per_run_cluster_csv: bool = False) -> None:
    """NPZ + t_obs CSV + cluster-summary rows (reference :1076-1185)."""
    stem = filemgmt.file_title(cfg.hypothesis_label, "")
    np.savez(Path(cfg.output_dir) / (stem + ".npz"),
             t_obs=results["t_obs"], cluster_pv=results["cluster_pv"],
             H0=results["H0"], ch_names=results["ch_names"],
             time_grid=results["time_grid"],
             good_cluster_inds=results["good_cluster_inds"])

    t_obs = results["t_obs"]
    time_grid = results["time_grid"]
    ch_names = results["ch_names"]
    t_ax = (time_grid if time_grid is not None
            else np.arange(t_obs.shape[0]))
    pd.DataFrame(t_obs, index=pd.Index(np.round(t_ax, 4), name="time_s"),
                 columns=ch_names).to_csv(
        Path(cfg.output_dir) / (stem + "_t_obs.csv"))

    n_times, n_ch = t_obs.shape
    axis_label = ("phase_deg" if cfg.use_phase_normalization else "time_s")
    rows = []
    for idx, (cluster, pv) in enumerate(zip(results["clusters"],
                                            results["cluster_pv"])):
        mask = (cluster if isinstance(cluster, np.ndarray)
                and cluster.dtype == bool else None)
        if mask is None:
            mask = np.zeros((n_times, n_ch), bool)
            mask[cluster] = True
        elif mask.ndim == 1:
            mask = mask.reshape(n_times, n_ch)
        t_in = np.where(mask.any(axis=1))[0]
        ch_in = np.where(mask.any(axis=0))[0]
        rows.append({
            "hypothesis": cfg.hypothesis_label,
            "modality": cfg.modality, "freq_band": cfg.freq_band,
            "condition_column": cfg.condition_column,
            "condition_A": cfg.condition_A,
            "condition_B": cfg.condition_B,
            "n_within_trial_segs": cfg.n_within_trial_segs,
            "n_permutations": cfg.n_permutations,
            "alpha_cluster_forming": cfg.alpha_cluster_forming,
            "tail": cfg.tail,
            "n_valid_subjects": results["n_valid_subjects"],
            "cluster_index": idx + 1,
            "p_value": round(float(pv), 6),
            "significant": bool(idx in results["good_cluster_inds"]),
            "peak_t": round(float(np.abs(t_obs[mask]).max())
                            if mask.any() else 0.0, 4),
            "t_thresh": round(float(results["t_thresh"]), 4),
            "n_time_points": int(len(t_in)),
            f"{axis_label}_start": (round(float(t_ax[t_in[0]]), 4)
                                    if len(t_in) else None),
            f"{axis_label}_end": (round(float(t_ax[t_in[-1]]), 4)
                                  if len(t_in) else None),
            "n_channels": int(len(ch_in)),
            "channels": "; ".join(ch_names[i] for i in ch_in),
        })
    if cluster_rows_accumulator is not None:
        cluster_rows_accumulator.extend(rows)
    if save_per_run_cluster_csv:
        pd.DataFrame(rows).to_csv(
            Path(cfg.output_dir) / (stem + "_cluster_summary.csv"),
            index=False)


def run_batch(configs: list[CBPAConfig]):
    """Run configs sequentially; save combined cluster summary
    (reference :1214-1250)."""
    all_results = []
    rows: list[dict] = []
    for i, cfg in enumerate(configs):
        print(f"\n[{i + 1}/{len(configs)}] Starting: "
              f"{cfg.hypothesis_label}")
        all_results.append(run_cbpa(cfg, cluster_rows_accumulator=rows))
    combined = pd.DataFrame(rows)
    if not combined.empty:
        out_path = Path(configs[0].output_dir) / filemgmt.file_title(
            "CBPA Combined Cluster Summary", ".csv")
        combined.to_csv(out_path, index=False)
        print(f"  Combined cluster summary -> {out_path} "
              f"({len(combined)} clusters, "
              f"{int(combined['significant'].sum())} significant)")
    return all_results, combined


# ══════════════════════════════════════════════════════════════════════
#  phase-average map assembly (for the phase-average figures,
#  reference visualizations.py:3143-3733 load their data inline; here the
#  assembly is a pipeline function so the plots stay data-first)
# ══════════════════════════════════════════════════════════════════════
def assemble_phase_average_maps(cfg: CBPAConfig,
                                subject_ids: list[int] | None = None):
    """Cohort-mean band-power map over (phase-or-time × channel).

    Pools EVERY valid trial (all conditions) of every subject: per subject
    the per-cycle phase profiles (``use_phase_normalization``) or per-trial
    resampled time courses are averaged, then averaged across subjects.

    Returns (grid, cohort_map (n_grid, n_ch), ch_names) — grid is phase
    degrees under phase normalisation, else seconds.
    """
    if subject_ids is None:
        stats_df = load_stats_frame(cfg.data_root)
        subject_ids = sorted(stats_df["Subject ID"].astype(int).unique())
    if cfg.exclude_subjects:
        subject_ids = [s for s in subject_ids
                       if s not in cfg.exclude_subjects]

    if cfg.modality == "CMC":
        ch_indices = None
        ch_names = (cfg.channels if cfg.channels is not None
                    else CMC_EEG_CHANNEL_SUBSET)
    else:
        ch_indices = ([EEG_CHANNEL_IND_DICT[ch] for ch in cfg.channels]
                      if cfg.channels is not None else None)
        ch_names = cfg.channels or None

    grid = (np.linspace(0, 360, cfg.n_phase_bins, endpoint=False)
            if cfg.use_phase_normalization else None)
    per_subject = []
    for subj in subject_ids:
        try:
            spectrogram, freqs, timestamps, log_df = _load_subject_data(
                cfg, subj)
        except Exception as exc:
            warnings.warn(f"Subject {subj:02}: load failed ({exc}). "
                          f"Skipping.")
            continue
        trial_spans = {int(k): v
                       for k, v in _get_trial_spans(log_df, cfg).items()}
        if not trial_spans:
            continue
        band_power = _extract_band_power(cfg, spectrogram, freqs,
                                         ch_indices)
        if cfg.use_phase_normalization:
            all_cond = {t: "all" for t in trial_spans}
            cycles = _band_power_per_phase(cfg, band_power, timestamps,
                                           trial_spans, all_cond,
                                           log_df).get("all", [])
            if not cycles:
                continue
            per_subject.append(np.nanmean(np.stack(cycles, axis=0),
                                          axis=0))
        else:
            if grid is None:
                grid = _common_time_grid_from_spans(
                    cfg, trial_spans, overlap_ratio=cfg.overlap_ratio)
            trial_data, _ = _band_power_per_trial(
                cfg, band_power, timestamps, trial_spans, len(grid))
            if trial_data.shape[0] == 0:
                continue
            per_subject.append(np.nanmean(trial_data, axis=0))
    if not per_subject:
        raise RuntimeError("[phase maps] no subject produced data")
    cohort = np.nanmean(np.stack(per_subject, axis=0), axis=0)
    return grid, cohort, ch_names


def assemble_accuracy_phase_profiles(cfg: CBPAConfig,
                                     experiment_results_dir,
                                     subject_ids: list[int],
                                     condition_column: str | None = None):
    """Phase-normalised trial-accuracy profiles pooled per condition.

    Per trial: the accuracy sampler's squared-error series (reference
    measurements_and_interactive_visuals.py:1783-1840, aligned via the
    5.5-s accuracy offset) is cycle-segmented at the trial's task
    frequency onto the cfg phase grid; profiles are grouped by the
    enriched-log condition.  Returns {condition: [profiles]}.
    """
    from pathlib import Path as _Path

    cond_col = condition_column or cfg.condition_column
    phase_grid = np.linspace(0, 360, cfg.n_phase_bins, endpoint=False)
    by_cond: dict[str, list[np.ndarray]] = {}
    for subj in subject_ids:
        sdir = _Path(experiment_results_dir) / f"subject_{int(subj):02}"
        try:
            log_df = data_integration.fetch_enriched_log_frame(
                sdir, verbose=False)
        except (FileNotFoundError, ValueError):
            continue
        spans = data_integration.get_all_task_start_ends(log_df, "dict")
        for trial_id, (t_start, t_end) in spans.items():
            sel = log_df["Trial ID"] == trial_id
            freqs = pd.to_numeric(log_df.loc[sel, "Task Frequency"],
                                  errors="coerce").dropna()
            if freqs.empty or freqs.iloc[0] <= 0:
                continue
            task_freq = float(freqs.iloc[0])
            song_ids = log_df.loc[sel, "Song ID"].dropna().unique()
            sil_ids = log_df.loc[sel, "Silence ID"].dropna().unique()
            try:
                if len(song_ids):
                    acc = data_integration.fetch_trial_accuracy(
                        sdir, song_id=int(song_ids[0]))
                elif len(sil_ids):
                    acc = data_integration.fetch_trial_accuracy(
                        sdir, silence_id=int(sil_ids[0]))
                else:
                    continue
            except (FileNotFoundError, ValueError):
                continue
            if acc is None:
                continue
            acc = np.asarray(acc, float)
            if acc.size < 4:
                continue
            trial_dur = (t_end - t_start).total_seconds()
            t_rel = data_integration.build_accuracy_relative_time_axis(
                len(acc), trial_dur,
                start_offset_sec=(
                    data_integration.TRIAL_ACCURACY_START_OFFSET_SEC))
            if len(t_rel) != len(acc):
                continue
            cond_vals = log_df.loc[sel, cond_col].dropna() \
                if cond_col in log_df.columns else pd.Series(["all"])
            cond = str(cond_vals.iloc[0]) if len(cond_vals) else "all"
            cycles = data_analysis.phase_normalize_cycles(
                signal=acc[:, None], t_rel=np.asarray(t_rel, float),
                task_freq=task_freq, trial_dur_sec=trial_dur,
                phase_grid=phase_grid,
                min_samples_per_cycle=cfg.min_samples_per_cycle,
                verbose=False)
            for prof in cycles:
                by_cond.setdefault(cond, []).append(
                    np.asarray(prof).reshape(len(phase_grid)))
    return by_cond
