"""Profile stage 4 (Combined Statistics frame assembly) on a synthetic
study tree.

Stage 4 of the five-stage pipeline benchmark is a pure host-pandas path
(reference ``statistics_data_preparation_workflow.py:179-632``) that a
faster device kernel does not move.  This harness rebuilds just the
inputs stage 4 consumes (subject trees + lean band-aggregate artifacts
+ enriched serial frames) and cProfiles ``build_combined_statistics_
frame`` so the hot callees are attributable without an accelerator or a full
pipeline run:

    python tools/profile_s4.py [n_subjects] [n_seg]
"""
from __future__ import annotations

import cProfile
import pstats
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pandas as pd

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import synth_study as S                                    # noqa: E402


def build_tree(n_subjects: int) -> tuple[Path, Path, Path, Path]:
    from mba_tpu.pipeline import signal_features as features
    from mba_tpu.utils import file_management as filemgmt

    work = Path(tempfile.mkdtemp(prefix="profile_s4_"))
    exp_root = work / "data" / "experiment_results"
    feat_root = work / "data" / "precomputed_features"
    plan = S.TrialPlan()
    lookup = S.write_music_lookup(work / "data" / "song_characteristics",
                                  plan)
    rng = np.random.default_rng(0)
    # lean artifacts at the bench's window grids (PSD 1 s hop 0.5,
    # CMC 2 s hop 1.0 — band_aggregate payloads, not full grids)
    n_psd = int(plan.rec_sec / 0.5) - 1
    n_cmc = int(plan.rec_sec / 1.0) - 1
    names = ["theta", "alpha", "beta", "gamma", "all"]
    edges = np.array([[4, 8], [8, 13], [16, 28], [30, 45], [4, 100.]])
    t_psd = np.arange(n_psd) * 0.5 + 0.5
    t_cmc = np.arange(n_cmc) * 1.0 + 1.0
    for s in range(n_subjects):
        S.write_subject_tree(exp_root, s, plan, write_raw_serial=False)
        sub_feat = feat_root / f"subject_{s:02}"
        sub_feat.mkdir(parents=True)
        for modality, nch in (("eeg", 64), ("emg_1_flexor", 64),
                              ("emg_2_extensor", 64)):
            payload = rng.normal(-10, 1, (n_psd, len(names), nch, 2)
                                 ).astype(np.float32)
            features.save_band_aggregates(payload, t_psd, names, edges,
                                          "PSD", sub_feat,
                                          identifier_suffix=modality)
        for muscle in ("Flexor", "Extensor"):
            payload = rng.uniform(0, 1, (n_cmc, len(names), 6, 2)
                                  ).astype(np.float32)
            features.save_band_aggregates(
                payload, t_cmc, names, edges, "CMC", sub_feat,
                identifier_suffix=f"{muscle} Trial-wise Channels_X")
        # enriched serial frame (50 Hz session trace)
        n = int(plan.rec_sec * S.SERIAL_HZ)
        times = S.qtc0() + pd.to_timedelta(np.arange(n) / S.SERIAL_HZ,
                                           unit="s")
        ser = pd.DataFrame({
            "Task-wise Scaled Force": rng.uniform(0, 1, n),
            "Unscaled Force [% MVC]": rng.uniform(0, 60, n),
            "bpm": rng.normal(70, 5, n), "hrv": rng.normal(50, 10, n),
            "gsr": rng.normal(2, 0.2, n)}, index=times)
        ser.index.name = "Time"
        out_dir = exp_root / f"subject_{s:02}" / "serial_measurements"
        ser.to_csv(out_dir / filemgmt.file_title(
            "Enriched Serial Frame", ".csv"))
    return work, exp_root, feat_root, lookup


def main():
    n_subjects = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    n_seg = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    from mba_tpu.workflows.statistics_data_preparation_workflow import \
        build_combined_statistics_frame

    t0 = time.perf_counter()
    work, exp_root, feat_root, lookup = build_tree(n_subjects)
    print(f"[setup] {n_subjects}-subject tree in "
          f"{time.perf_counter() - t0:.1f}s -> {work}", file=sys.stderr)

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    df = build_combined_statistics_frame(
        list(range(n_subjects)), exp_root, feat_root, n_seg,
        save=False, music_lookup_table_path=lookup)
    prof.disable()
    wall = time.perf_counter() - t0
    print(f"[s4] {n_subjects} subjects x {n_seg}seg: {wall:.2f}s "
          f"({len(df)} rows); 12-subj x 4-res scale-up "
          f"~{wall * 12 / n_subjects * 4:.0f}s", file=sys.stderr)
    stats = pstats.Stats(prof, stream=sys.stderr)
    stats.sort_stats("cumulative").print_stats(25)

    import shutil
    shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
