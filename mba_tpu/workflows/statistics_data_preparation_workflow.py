"""Build the "Combined Statistics Nseg" frames — the modelling substrate.

Parity target: reference ``src/statistics_data_preparation_workflow.py``
(631 LoC): per subject derive segment spans (latency 3.25 s, end cutoff
2 s, onset discard 6.5 s; :35-44, :179-247), aggregate PSD hypotheses
H2–H5 + EMG validation (:72-97, :252-294), the 8 CMC DVs (muscle ×
max/mean × β/γ; :100-121, :296-336), serial medians (force/HR/HRV/GSR;
:338-563), trial accuracy with the 5.5-s offset alignment (:386-492),
music features, questionnaire modes, subject-level traits (:494-598),
cross-subject centering/squaring (:611-627) and the timestamped CSV save
(:629-632).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd

from mba_tpu.pipeline import signal_features as features
from mba_tpu.pipeline import data_integration
from mba_tpu.pipeline import data_analysis
from mba_tpu.channel_layout import EEG_CHANNEL_IND_DICT, \
    EEG_CHANNELS_BY_AREA
from mba_tpu.utils import file_management as filemgmt

# PSD hypothesis configurations (reference :72-85)
PSD_HYPOTHESES: list[tuple] = [
    ('eeg', 'FC_CP_T',
     EEG_CHANNELS_BY_AREA['Fronto-Central']
     + EEG_CHANNELS_BY_AREA['Centro-Parietal']
     + EEG_CHANNELS_BY_AREA['Temporal'], 'theta'),          # H2
    ('eeg', 'F_C', EEG_CHANNELS_BY_AREA['Frontal']
     + EEG_CHANNELS_BY_AREA['Central'], 'beta'),            # H3
    ('eeg', 'P_PO', EEG_CHANNELS_BY_AREA['Parietal']
     + EEG_CHANNELS_BY_AREA['Parieto-Occipital'], 'alpha'),  # H4
    ('eeg', 'Global', None, 'gamma'),
    ('emg_1_flexor', 'Global', None, 'all'),
    ('emg_2_extensor', 'Global', None, 'all'),
]

# CMC DV configurations (reference :100-110)
CMC_DVS: list[tuple] = [
    ('Flexor', 'max', 'beta'), ('Flexor', 'max', 'gamma'),
    ('Flexor', 'mean', 'beta'), ('Flexor', 'mean', 'gamma'),
    ('Extensor', 'max', 'beta'), ('Extensor', 'max', 'gamma'),
    ('Extensor', 'mean', 'beta'), ('Extensor', 'mean', 'gamma'),
]

MUSIC_FEATURES_TO_FETCH = ('BPM_manual', 'Spectral Flux Mean',
                           'Spectral Centroid Mean', 'IOI Variance Coeff',
                           'Syncopation Ratio', 'Spectral Flux Std.')

CENTER_OVER_SUBJECTS = ['Liking', 'Listening habit [0-3]',
                        'Dancing habit [0-7]', 'Athleticism [0-7]',
                        'Musical skill [0-7]']
SQUARE_COLUMNS = ['Liking_centered']


def derive_segment_spans(log_df: pd.DataFrame,
                         n_within_trial_segments: int,
                         n_onset_seconds_to_discard: float = 6.5,
                         task_latency_assumption_sec: float = 3.25,
                         task_end_transient_cutoff_sec: float = 2.0,
                         trial_spans: dict | None = None):
    """Trial spans → equal-width segment spans (reference :179-247).

    ``trial_spans`` — optional precomputed
    :func:`data_integration.get_all_task_start_ends` dict (it is
    n_seg-invariant, so multi-resolution callers compute it once).
    """
    if trial_spans is None:
        trial_spans = data_integration.get_all_task_start_ends(
            log_df, 'dict',
            assumed_latency_sec=task_latency_assumption_sec,
            cut_off_sec_to_prevent_transients=task_end_transient_cutoff_sec)
    seg_starts, seg_ends, seg_ids = [], [], []
    onset_delta = pd.Timedelta(seconds=n_onset_seconds_to_discard)
    for trial_id, (start, end) in trial_spans.items():
        effective_start = start + onset_delta
        if effective_start >= end:
            print(f"  [WARNING] Trial {trial_id}: onset discard exceeds "
                  f"trial duration. Skipping.")
            continue
        grid = pd.date_range(effective_start, end,
                             periods=n_within_trial_segments + 1,
                             inclusive='both')
        for ind in range(n_within_trial_segments):
            seg_ids.append(ind)
            seg_starts.append(data_analysis.make_timezone_aware(
                pd.Timestamp(grid.values[ind])))
            seg_ends.append(data_analysis.make_timezone_aware(
                pd.Timestamp(grid.values[ind + 1])))
    return seg_starts, seg_ends, seg_ids


def _segment_op(seg_starts, seg_ends, target, timestamps=None,
                operation='mean'):
    return data_analysis.apply_window_operator(
        window_timestamps=seg_starts, window_timestamps_ends=seg_ends,
        target_array=target, target_timestamps=timestamps,
        operation=operation, axis=0)


def build_subject_frame(subject_ind: int, experiment_data_dir: Path,
                        feature_data_dir: Path,
                        n_within_trial_segments: int,
                        psd_time_window_size_sec: float = 0.25,
                        cmc_time_window_size_sec: float = 2.0,
                        psd_is_log_scaled: bool = True,
                        n_onset_seconds_to_discard: float = 6.5,
                        task_latency_assumption_sec: float = 3.25,
                        task_end_transient_cutoff_sec: float = 2.0,
                        music_lookup_table_path=None,
                        psd_hypotheses=None,
                        cmc_dvs=None,
                        input_cache: dict | None = None) -> pd.DataFrame:
    """One subject's rows of the Combined Statistics frame.

    ``input_cache`` — optional dict shared across calls.  Everything a
    subject's rows need that does NOT depend on
    ``n_within_trial_segments`` (the enriched log/serial frames and
    their timezone conversion, QTC bounds, personal data, per-trial
    accuracy traces, per-trial music features) is stored under
    ``(subject_ind, kind, ...)`` keys and reused on later calls — the
    study workflow builds the frame at four segment resolutions, and
    without the cache each repeats every CSV read and enrichment pass.
    Cached frames are served by reference and must be treated
    read-only (this function only reads them).  Pass a fresh dict if
    the on-disk experiment data may have changed between calls.
    """
    psd_hypotheses = psd_hypotheses if psd_hypotheses is not None \
        else PSD_HYPOTHESES
    cmc_dvs = cmc_dvs if cmc_dvs is not None else CMC_DVS
    subject_exp_dir = Path(experiment_data_dir) \
        / f"subject_{subject_ind:02}"
    subject_feat_dir = Path(feature_data_dir) \
        / f"subject_{subject_ind:02}"
    cache = input_cache if input_cache is not None else {}

    key = (subject_ind, 'frames')
    if key not in cache:
        log_df = data_integration.fetch_enriched_log_frame(
            subject_exp_dir, verbose=False)
        serial_df = data_integration.fetch_enriched_serial_frame(
            subject_exp_dir)
        log_df.index = data_analysis.make_timezone_aware(log_df.index)
        serial_df.index = data_analysis.make_timezone_aware(
            serial_df.index)
        qtc_start, qtc_end = \
            data_integration.get_qtc_measurement_start_end(log_df, False)
        cache[key] = (log_df, serial_df, qtc_start, qtc_end,
                      serial_df[qtc_start:qtc_end])
    log_df, serial_df, qtc_start, qtc_end, sliced_serial_df = cache[key]

    tkey = (subject_ind, 'trial_spans', task_latency_assumption_sec,
            task_end_transient_cutoff_sec)
    if tkey not in cache:
        cache[tkey] = data_integration.get_all_task_start_ends(
            log_df, 'dict',
            assumed_latency_sec=task_latency_assumption_sec,
            cut_off_sec_to_prevent_transients=
            task_end_transient_cutoff_sec)
    seg_starts, seg_ends, seg_ids = derive_segment_spans(
        log_df, n_within_trial_segments,
        n_onset_seconds_to_discard=n_onset_seconds_to_discard,
        task_latency_assumption_sec=task_latency_assumption_sec,
        task_end_transient_cutoff_sec=task_end_transient_cutoff_sec,
        trial_spans=cache[tkey])
    if not seg_starts:
        raise RuntimeError(
            f"subject {subject_ind}: no valid segments — check the "
            f"latency/cutoff/onset-discard timing configuration against "
            f"the trial durations.")
    # normalize the segment spans ONCE: every _segment_op below would
    # otherwise re-run pd.to_datetime over the same Timestamp lists
    # (~25 calls per subject per resolution — visible in the stage-4
    # profile); element access and comparisons are unchanged
    seg_starts = pd.DatetimeIndex(seg_starts).as_unit("ns")
    seg_ends = pd.DatetimeIndex(seg_ends).as_unit("ns")
    frame = pd.DataFrame(index=range(len(seg_starts)))

    # ── PSD hypotheses (reference :252-294) ───────────────────────────
    # A band-aggregate artifact (the device-first lean feature store,
    # features.BandAggregates) is preferred when present: its stored
    # per-(window, channel) band means are exactly the values the
    # full-grid aggregation below computes, because the band mean over
    # frequency commutes with the subsequent channel-axis reduction.
    # Absent the artifact, the reference-parity full-spectrogram path
    # runs unchanged.
    for modality, region_label, channels, band in psd_hypotheses:
        ch_idx = ([EEG_CHANNEL_IND_DICT[ch] for ch in channels]
                  if channels is not None else None)
        ch_op = np.nanmean if 'eeg' in modality else np.nanmax
        bkey = (subject_ind, 'bandagg', 'PSD', modality)
        if bkey not in cache:
            try:
                cache[bkey] = features.fetch_band_aggregates(
                    subject_feat_dir, 'PSD', file_identifier=modality)
            except (ValueError, FileNotFoundError):
                cache[bkey] = None
        agg_art = cache[bkey]
        aggregated = None
        if agg_art is not None:
            # a lean artifact can lack the requested band (bands outside
            # the stored frequency axis are dropped at save time) — fall
            # back to the full-grid spectrogram path instead of failing
            try:
                per_channel = agg_art.select(band, 'mean',
                                             channel_indices=ch_idx)
            except ValueError:
                per_channel = None
            if per_channel is not None:
                n_times = agg_art.n_windows
                aggregated = ch_op(per_channel, axis=1)
        if aggregated is None:
            spec, times, freqs = features.fetch_stored_spectrograms(
                subject_feat_dir, modality='PSD', file_identifier=modality)
            n_times = len(times)
            aggregated = features.aggregate_psd_spectrogram(
                spec, freqs, normalize_mvc=False,
                channel_indices=ch_idx,
                is_log_scaled=psd_is_log_scaled, freq_slice=band,
                aggregation_ops=[('mean', 1),
                                 ('mean' if 'eeg' in modality
                                  else 'max', 1)])
        timestamps = data_analysis.make_timezone_aware(
            data_analysis.add_time_index(
                start_timestamp=qtc_start + pd.Timedelta(
                    seconds=psd_time_window_size_sec / 2),
                end_timestamp=qtc_end - pd.Timedelta(
                    seconds=psd_time_window_size_sec / 2),
                n_timesteps=n_times))
        frame[f"PSD_{modality}_{region_label}_{band}"] = _segment_op(
            seg_starts, seg_ends, aggregated, timestamps)

    # ── CMC DVs (reference :296-336) ──────────────────────────────────
    for muscle, operator, band in cmc_dvs:
        bkey = (subject_ind, 'bandagg', 'CMC', muscle)
        if bkey not in cache:
            try:
                cache[bkey] = features.fetch_band_aggregates(
                    subject_feat_dir, 'CMC', file_identifier=muscle)
            except (ValueError, FileNotFoundError):
                cache[bkey] = None
        agg_art = cache[bkey]
        aggregated = None
        if agg_art is not None:
            # stored per-channel band MAX, then the DV's channel op —
            # the same [('max', 1), (operator, 1)] order as below;
            # missing-band artifacts fall back to the full grid
            try:
                per_channel = agg_art.select(band, 'max')
            except ValueError:
                per_channel = None
            if per_channel is not None:
                n_times = agg_art.n_windows
                ch_op = np.nanmean if operator == 'mean' else np.nanmax
                aggregated = ch_op(per_channel, axis=1)
        if aggregated is None:
            spec, times, freqs = features.fetch_stored_spectrograms(
                subject_feat_dir, modality='CMC', file_identifier=muscle)
            n_times = len(times)
            aggregated = features.aggregate_psd_spectrogram(
                spec, freqs, normalize_mvc=False, is_log_scaled=False,
                freq_slice=band,
                aggregation_ops=[('max', 1), (operator, 1)])
        timestamps = data_analysis.make_timezone_aware(
            data_analysis.add_time_index(
                start_timestamp=qtc_start + pd.Timedelta(
                    seconds=cmc_time_window_size_sec / 2),
                end_timestamp=qtc_end - pd.Timedelta(
                    seconds=cmc_time_window_size_sec / 2),
                n_timesteps=n_times))
        frame[f"CMC_{muscle}_{operator}_{band}"] = _segment_op(
            seg_starts, seg_ends, aggregated, timestamps)

    # ── serial + log segment aggregates (reference :338-563) ──────────
    if (subject_ind, 'personal') not in cache:
        cache[(subject_ind, 'personal')] = \
            data_integration.fetch_personal_data(subject_exp_dir)
    subject_level = cache[(subject_ind, 'personal')]
    # all eight per-segment log modes share windows and timestamps —
    # one 2-D call assigns the ~50k log rows to segments once instead
    # of eight times (stage-4 profile, tools/profile_s4.py)
    mode_cols = ['Song ID', 'Silence ID', 'Trial ID', 'Task Frequency',
                 'Emotional State', 'Perceived Category', 'Liking',
                 'Familiarity']
    log_modes = data_analysis.apply_window_operator(
        window_timestamps=seg_starts, window_timestamps_ends=seg_ends,
        target_array=log_df[mode_cols].to_numpy(dtype=object),
        target_timestamps=log_df.index, operation='mode', axis=0)
    song_id, silence_id, trial_id = (log_modes[:, 0], log_modes[:, 1],
                                     log_modes[:, 2])
    is_music = [not pd.isna(s) and pd.isna(q)
                for s, q in zip(song_id, silence_id)]

    # trial accuracy with the 5.5-s warm-up alignment (reference :386)
    accuracy = [float('nan')] * len(seg_starts)
    trial_rows: dict[int, list[int]] = {}
    for row, tid in enumerate(trial_id):
        if not pd.isna(tid):
            trial_rows.setdefault(int(tid), []).append(row)
    def _trial_accuracy_axis(tid: int):
        """(acc, acc_start, acc_ts, acc_max) or None — n_seg-invariant."""
        acc = data_integration.fetch_trial_accuracy(
            subject_exp_dir, log_df=log_df, trial_id=tid,
            error_handling='continue')
        if acc is None:
            return None
        try:
            full_start, full_end = data_integration.get_task_start_end(
                log_df, trial_id=tid,
                cut_off_sec_to_prevent_transients=0.0,
                assumed_latency_sec=task_latency_assumption_sec)
        except ValueError:
            return None
        acc_start = full_start + pd.Timedelta(
            seconds=data_integration.TRIAL_ACCURACY_START_OFFSET_SEC)
        if acc_start >= full_end:
            return None
        t_rel = data_integration.build_accuracy_relative_time_axis(
            n_samples=len(acc),
            trial_dur_sec=(full_end - full_start).total_seconds(),
            start_offset_sec=
            data_integration.TRIAL_ACCURACY_START_OFFSET_SEC)
        if t_rel.size == 0:
            return None
        acc_ts = full_start + pd.to_timedelta(t_rel, unit='s')
        return acc, acc_start, acc_ts, acc_ts.max()

    for tid, rows in trial_rows.items():
        akey = (subject_ind, 'acc', tid, task_latency_assumption_sec)
        if akey not in cache:
            cache[akey] = _trial_accuracy_axis(tid)
        if cache[akey] is None:
            continue
        acc, acc_start, acc_ts, acc_max = cache[akey]
        valid, tss, tse = [], [], []
        for row in rows:
            if seg_ends[row] < acc_start or seg_starts[row] > acc_max:
                continue
            valid.append(row)
            tss.append(max(seg_starts[row], acc_start))
            tse.append(min(seg_ends[row], acc_max))
        if not valid:
            continue
        agg = np.sqrt(_segment_op(tss, tse, acc, acc_ts,
                                  operation='mean').astype(float))
        for local, row in enumerate(valid):
            val = agg[local]
            accuracy[row] = float(val) if not pd.isna(val) else \
                float('nan')

    # music features per segment's trial (reference :494-499); the
    # lookup CSV is read once and features resolved once per unique
    # trial (segments of one trial share its song)
    if music_lookup_table_path is not None:
        if isinstance(music_lookup_table_path, pd.DataFrame):
            lookup_df = music_lookup_table_path
        else:
            lkey = ('lookup', str(music_lookup_table_path))
            if lkey not in cache:
                cache[lkey] = pd.read_csv(music_lookup_table_path)
            lookup_df = cache[lkey]

        def _music(tid: int):
            mkey = (subject_ind, 'music', tid)
            if mkey not in cache:
                cache[mkey] = data_integration.fetch_music_features(
                    log_df, trial_id=tid,
                    music_lookup_table_path=lookup_df,
                    features_to_return=MUSIC_FEATURES_TO_FETCH)
            return cache[mkey]

        per_trial = {int(tid): _music(int(tid))
                     for tid in pd.unique(pd.Series(trial_id).dropna())}
        music_tuples = [
            per_trial[int(tid)] if not pd.isna(tid)
            else [np.nan] * len(MUSIC_FEATURES_TO_FETCH)
            for tid in trial_id]
    else:
        music_tuples = [[np.nan] * len(MUSIC_FEATURES_TO_FETCH)
                        for _ in trial_id]

    perceived = log_modes[:, 5]
    category_or_silence = pd.Series(perceived).fillna('Silence')

    # the five serial medians share timestamps and windows — one 2-D
    # window-operator call replaces five single-column passes (each
    # repeats the argsort/searchsorted assignment of the ~85k-sample
    # serial trace; stage-4 profile, tools/profile_s4.py)
    serial_cols = ['Task-wise Scaled Force', 'Unscaled Force [% MVC]',
                   'bpm', 'hrv', 'gsr']
    serial_med = data_analysis.apply_window_operator(
        window_timestamps=seg_starts, window_timestamps_ends=seg_ends,
        target_array=sliced_serial_df[serial_cols].to_numpy(dtype=float),
        target_timestamps=sliced_serial_df.index,
        operation='median', axis=0)
    columns = [
        ('Subject ID', [subject_ind] * len(seg_starts)),
        ('Trial ID', trial_id),
        ('Music Listening', is_music),
        ('Median Scaled Force [0-1]', serial_med[:, 0]),
        ('Median Unscaled Force [% MVC]', serial_med[:, 1]),
        ('Task Frequency', log_modes[:, 3]),
        ('Emotional_State', log_modes[:, 4]),
        ('Median_Heart_Rate', serial_med[:, 2]),
        ('Median_HRV', serial_med[:, 3]),
        ('GSR', serial_med[:, 4]),
        ('Perceived Category', perceived),
        ('Category or Silence', category_or_silence),
        ('Liking', log_modes[:, 6]),
        ('Familiarity [0-7]', log_modes[:, 7]),
        (list(MUSIC_FEATURES_TO_FETCH), music_tuples),
        ('Segment ID', seg_ids),
        ('RMS_Accuracy', accuracy),
        ('Listening habit [0-3]',
         [subject_level['Listening habit [0-3]']] * len(seg_starts)),
        ('Dancing habit [0-7]',
         [subject_level['Dancing habit']] * len(seg_starts)),
        ('Athleticism [0-7]',
         [subject_level['Athleticism']] * len(seg_starts)),
        ('Musical skill [0-7]',
         [subject_level['Musical skill']] * len(seg_starts)),
    ]
    for column_name, data in columns:
        frame[column_name] = data
    return frame


def build_combined_statistics_frame(subject_ids: list[int],
                                    experiment_data_dir: Path,
                                    feature_data_dir: Path,
                                    n_within_trial_segments: int,
                                    save: bool = True,
                                    **kwargs) -> pd.DataFrame:
    """All subjects → centered/squared Combined Statistics frame.

    Accepts ``input_cache`` (see :func:`build_subject_frame`) — share
    one dict across the four segment-resolution builds to skip the
    repeated per-subject CSV reads and enrichment passes.
    """
    frames = [build_subject_frame(s, experiment_data_dir,
                                  feature_data_dir,
                                  n_within_trial_segments, **kwargs)
              for s in subject_ids]
    combined = pd.concat(frames, axis=0, ignore_index=True)

    # centering over all subjects (reference :611-619)
    for modality in CENTER_OVER_SUBJECTS:
        for column in [c for c in combined.columns if modality in c
                       and not c.endswith("_centered")]:
            combined[f"{column}_centered"] = pd.to_numeric(
                combined[column], errors="coerce")
            combined[f"{column}_centered"] -= \
                combined[f"{column}_centered"].mean()
    for modality in SQUARE_COLUMNS:
        for column in [c for c in combined.columns if modality in c
                       and not c.endswith("_squared")]:
            combined[f"{column}_squared"] = pd.to_numeric(
                combined[column], errors="coerce") ** 2

    if save:
        out = Path(feature_data_dir) / filemgmt.file_title(
            f"Combined Statistics {int(n_within_trial_segments)}seg",
            ".csv")
        combined.to_csv(out, index=False)
        print(f"Saved combined statistics frame -> {out} "
              f"({len(combined)} rows)")
    return combined


if __name__ == "__main__":
    from mba_tpu.workflows.paths import StudyPaths

    current_subject_count = 12
    overwrite = True
    n_within_trial_segments_list = [1, 2, 5, 10]

    paths = StudyPaths().ensure()
    for n_seg in n_within_trial_segments_list:
        if not overwrite:
            try:
                filemgmt.most_recent_file(
                    paths.feature_data, ".csv",
                    [f"Combined Statistics {n_seg}seg"])
                print(f"Frame for {n_seg}seg already exists.")
                continue
            except ValueError:
                pass
        build_combined_statistics_frame(
            list(range(current_subject_count)), paths.experiment_data,
            paths.feature_data, n_seg)
