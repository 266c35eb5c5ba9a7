"""Synthesize a reference-format 12-subject study tree at full scale.

The pipeline benchmark runs the heavy array stages (otb4 import →
preprocessing → feature extraction) for ONE real subject; the
statistics stages (combined frames, omnibus, CBPA) need the full
12-subject artifact tree the reference's acquisition + curation stages
would have produced (reference data layout per
data_integration.fetch_* loaders: ``experiment_results/subject_XX/
{experiment_logs, serial_measurements, song_XXX, silence_XXX,
Subject Data.json, Post-Study Feedback Data.json}``).  This module
fabricates that tree with study-scale timestamps so every downstream
consumer — ``get_qtc_measurement_start_end``, ``get_all_task_start_
ends``, ``build_subject_frame``, ``build_contrast_array`` — runs its
REAL parsing/alignment path on it.

Design of the planted effect (consumed by the benchmark's
scientific-correctness gates): every trial drives a beta-band (16-28 Hz)
EEG↔EMG coupling gated to the derived task span; MUSIC trials couple at
full gain, SILENCE trials at 0.4×, inter-trial gaps at 0 — so
music-vs-silence CMC contrasts are true positives and the rest-window
CMC is a true negative.

The signal synthesis (``TrialPlan``, ``synth_subject``) needs only numpy;
pandas is imported by the functions that write the artifact tree.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from mba_tpu.utils import file_management as filemgmt

FS = 2048.0
N_TRIALS = 30
TRIAL_SEC = 45.0
GAP_SEC = 12.0
PRE_ROLL_SEC = 2.0
POST_ROLL_SEC = 2.0
TASK_LATENCY_SEC = 3.25          # reference get_task_start_end default
TASK_END_CUTOFF_SEC = 2.0
TASK_FREQ_HZ = 0.1
CATEGORIES = ("Classic", "Happy", "Sad")
MUSIC_PATTERN = (1, 1, 1, 0, 1, 1, 1, 0, 1, 0)   # 7 music + 3 silence /10
BASE_TIME = "2026-01-05 10:00:00"
N_EEG = 64
N_EMG = 64
BETA_DRIVE = (16.0, 28.0)
QTC_LATENCY_SEC = 0.75           # get_qtc_measurement_start_end default
SILENCE_GAIN = 0.4
LOG_ROW_HZ = 4.0
SERIAL_HZ = 50.0
MUSIC_FEATURE_COLS = ("BPM_manual", "Spectral Flux Mean",
                      "Spectral Centroid Mean", "IOI Variance Coeff",
                      "Syncopation Ratio", "Spectral Flux Std.")


class TrialPlan:
    """Deterministic trial layout shared by all subjects (the CMC
    artifacts of subjects 1-11 are jittered from subject 0's, so the
    music/silence placement must be identical across subjects)."""

    def __init__(self, n_trials: int = N_TRIALS):
        self.trials = []          # dicts with all per-trial constants
        song_id = 0
        silence_id = 0
        cat_cycle = 0
        for i in range(n_trials):
            is_music = bool(MUSIC_PATTERN[i % len(MUSIC_PATTERN)])
            t_on = PRE_ROLL_SEC + i * (TRIAL_SEC + GAP_SEC)
            trial = {
                "trial_id": i,
                "is_music": is_music,
                "gui_on_sec": t_on,                  # log rows span
                "gui_off_sec": t_on + TRIAL_SEC,
                # span the reference's get_task_start_end will derive
                "task_start_sec": t_on + TASK_LATENCY_SEC,
                "task_end_sec": t_on + TRIAL_SEC + TASK_LATENCY_SEC
                                 - TASK_END_CUTOFF_SEC,
            }
            if is_music:
                trial["category"] = CATEGORIES[cat_cycle % 3]
                cat_cycle += 1
                trial["song_id"] = song_id
                song_id += 1
                trial["silence_id"] = None
            else:
                trial["category"] = None
                trial["song_id"] = None
                trial["silence_id"] = silence_id
                silence_id += 1
            self.trials.append(trial)
        self.n_songs = song_id
        self.n_silence = silence_id
        last = self.trials[-1]
        self.rec_sec = last["gui_off_sec"] + TASK_LATENCY_SEC \
            + POST_ROLL_SEC
        self.n_samples = int(self.rec_sec * FS)

    def drive_gate(self, rng: np.random.Generator) -> np.ndarray:
        """Per-sample coupling gain over the recording."""
        gate = np.zeros(self.n_samples, np.float32)
        for tr in self.trials:
            g = (1.0 if tr["is_music"] else SILENCE_GAIN) \
                * rng.uniform(0.9, 1.1)
            i0 = int(tr["task_start_sec"] * FS)
            i1 = int(tr["task_end_sec"] * FS)
            gate[i0:i1] = g
        return gate

    def signal_relative_spans(self, which: str = "music"):
        sel = {"music": lambda t: t["is_music"],
               "silence": lambda t: not t["is_music"]}[which]
        return [(t["task_start_sec"], t["task_end_sec"])
                for t in self.trials if sel(t)]


def synth_subject(plan: TrialPlan, seed=0):
    """EEG with planted blink/ECG/line/muscle artifacts + beta drive
    gated per-trial (music 1.0 / silence 0.4 / rest 0); two EMG
    montages sharing the drive.  Returns float32 (n, 64) arrays
    ``eeg, emg_flexor, emg_extensor``."""
    rng = np.random.default_rng(seed)
    n = plan.n_samples
    t = np.arange(n) / FS

    white = rng.standard_normal(n)
    spec = np.fft.rfft(white)
    f = np.fft.rfftfreq(n, 1 / FS)
    spec[(f < BETA_DRIVE[0]) | (f > BETA_DRIVE[1])] = 0
    drive = np.fft.irfft(spec, n=n).astype(np.float32)
    drive /= drive.std() + 1e-12
    drive *= plan.drive_gate(rng)

    blink = np.zeros(n, np.float32)
    for onset in rng.integers(0, n - int(FS), 150):
        w = int(0.3 * FS)
        blink[onset:onset + w] += np.hanning(w)[:len(blink[onset:onset + w])]
    ecg = np.zeros(n, np.float32)
    for beat in np.arange(0, n, int(0.85 * FS)):
        w = int(0.05 * FS)
        ecg[beat:beat + w] += np.hanning(w)[:len(ecg[beat:beat + w])] * 3
    line = np.sin(2 * np.pi * 50.0 * t).astype(np.float32)

    # mV-scale EEG (tens of µV = 1e-2 mV) — the reference pipeline's
    # working unit (reference preprocessing_workflow.py:61-76)
    eeg = rng.standard_normal((n, N_EEG), dtype=np.float32) * 1e-2
    # SIGNED per-channel gains (dipole polarity): an all-positive gain
    # profile is near-constant across the montage, so the average
    # reference and the Laplacian (both subtract cross-channel means)
    # would cancel most of the drive
    gains = rng.uniform(0.3, 1.0, N_EEG) * rng.choice([-1.0, 1.0], N_EEG)
    eeg += 5e-3 * drive[:, None] * gains[None, :].astype(np.float32)
    front = np.zeros(N_EEG, np.float32)
    front[:4] = [5e-2, 5e-2, 3e-2, 3e-2]
    eeg += blink[:, None] * front[None, :]
    eeg += ecg[:, None] * rng.uniform(1e-3, 4e-3, N_EEG)[None, :]
    eeg += 2e-3 * line[:, None] * rng.uniform(0.5, 1.5, N_EEG)[None, :]

    def emg_like(gain):
        x = rng.standard_normal((n, N_EMG), dtype=np.float32) * 0.05
        x += gain * drive[:, None] * rng.uniform(0.3, 1.0, N_EMG)[None, :]
        x += 0.01 * line[:, None]
        return x

    return eeg, emg_like(0.03), emg_like(0.008)


def qtc0():
    """Absolute timestamp of signal sample 0 (= qtc measurement start:
    Start Trigger is logged QTC_LATENCY_SEC earlier)."""
    import pandas as pd
    return pd.Timestamp(BASE_TIME) + pd.Timedelta(seconds=QTC_LATENCY_SEC)


def write_music_lookup(path: Path, plan: TrialPlan,
                       seed: int = 7) -> Path:
    import pandas as pd
    rng = np.random.default_rng(seed)
    rows = []
    for sid in range(plan.n_songs):
        rows.append({
            "Artist": "Artist", "Title": f"Track{sid:02}",
            "BPM_manual": float(rng.integers(60, 180)),
            "Spectral Flux Mean": float(rng.uniform(0.1, 2.0)),
            "Spectral Centroid Mean": float(rng.uniform(800, 4000)),
            "IOI Variance Coeff": float(rng.uniform(0.1, 1.2)),
            "Syncopation Ratio": float(rng.uniform(0.0, 0.6)),
            "Spectral Flux Std.": float(rng.uniform(0.05, 0.8)),
        })
    path.mkdir(parents=True, exist_ok=True)
    out = path / filemgmt.file_title("Song Characteristics Lookup Table",
                                     ".csv")
    pd.DataFrame(rows).to_csv(out, index=False)
    return out


def build_enriched_log(plan: TrialPlan, subject: int):
    """Enriched-log rows in the exact schema integrate_subject saves
    (probed column inventory of the acquisition dummy experiment)."""
    import pandas as pd
    base_time = pd.Timestamp(BASE_TIME)
    rng = np.random.default_rng(1000 + subject)
    t0 = qtc0()
    columns = ["Time", "Music", "Event", "Questionnaire",
               "Music Category", "Within Category Song Index",
               "Song Info", "Song Title", "Song Artist", "Song Runtime",
               "Task Frequency", "Task RMSE", "Phase", "Song ID",
               "Song Skipped", "Silence ID", "Trial ID", "Familiarity",
               "Liking", "Fitting Category", "Emotional State",
               "Other category", "Perceived Category", "Trial Comment",
               "Trial Exclusion Bool"]
    rows = []

    def event(t_abs, name):
        rows.append({"Time": t_abs, "Event": name,
                     "Music": "No track playing currently.",
                     "Music Category": "No category"})

    event(base_time - pd.Timedelta(seconds=5), "Onboarding complete")
    event(base_time, "Start Trigger")
    event(base_time + pd.Timedelta(seconds=0.2),
          "MVC calibrated: 15.00 kg")
    within_cat_count = {c: 0 for c in CATEGORIES}
    for tr in plan.trials:
        liking = int(rng.integers(1, 8))
        familiarity = int(rng.integers(0, 8))
        emotional = int(rng.integers(1, 10))
        cat = tr["category"]
        if cat is not None:
            within_cat_count[cat] += 1
        base = {
            "Trial ID": tr["trial_id"],
            "Task Frequency": TASK_FREQ_HZ,
            "Task RMSE": float(rng.uniform(150, 250)),
            "Song Skipped": False,
            "Trial Exclusion Bool": False,
            "Familiarity": familiarity,
            "Liking": liking,
            "Fitting Category": int(rng.integers(1, 8)),
            "Emotional State": emotional,
        }
        if tr["is_music"]:
            base.update({
                "Music Category": cat,
                "Perceived Category": cat,
                "Within Category Song Index": within_cat_count[cat],
                "Song ID": tr["song_id"],
                "Song Title": f"Track{tr['song_id']:02}",
                "Song Artist": "Artist",
                "Song Runtime": 180.0,
                "Song Info": f"Track{tr['song_id']:02} by Artist",
                "Music": f"{cat} | Track{tr['song_id']:02} by Artist",
                "Phase": f"{cat} Task",
            })
        else:
            base.update({
                "Music Category": "No category",
                "Music": "No track playing currently.",
                "Silence ID": tr["silence_id"],
                "Phase": "Silence Task",
            })
        step = 1.0 / LOG_ROW_HZ
        # include the endpoint row: the derived span is min..max of the
        # trial's Task Frequency rows, so the last row must sit exactly
        # at gui_off for the +latency/−cutoff algebra to land on
        # task_end_sec
        ts = np.arange(tr["gui_on_sec"], tr["gui_off_sec"], step)
        for t in np.append(ts, tr["gui_off_sec"]):
            rows.append({"Time": t0 + pd.Timedelta(seconds=float(t)),
                         **base})
    event(t0 + pd.Timedelta(seconds=plan.rec_sec - QTC_LATENCY_SEC),
          "Stop Trigger")
    event(t0 + pd.Timedelta(seconds=plan.rec_sec + 3),
          "Offboarding complete")
    df = pd.DataFrame(rows)
    for col in columns:
        if col not in df.columns:
            df[col] = np.nan
    return df[columns].sort_values("Time").reset_index(drop=True)


def synth_raw_serial(plan: TrialPlan, subject: int):
    """Raw serial trace (fsr volts, ecg, gsr) at SERIAL_HZ over the
    session — consumed by the REAL build_enriched_serial_frame path."""
    import pandas as pd
    rng = np.random.default_rng(2000 + subject)
    n = int(plan.rec_sec * SERIAL_HZ)
    t = np.arange(n) / SERIAL_HZ
    # force: 0.1 Hz tracking sine inside trials, rest baseline
    fsr = np.full(n, 1.0) + rng.normal(0, 0.01, n)
    for tr in plan.trials:
        sel = (t >= tr["task_start_sec"]) & (t < tr["task_end_sec"])
        fsr[sel] = (1.25 + 0.2 * np.sin(2 * np.pi * TASK_FREQ_HZ * t[sel])
                    + rng.normal(0, 0.02, sel.sum()))
    # one clean MVC peak so %MVC normalisation is stable
    fsr[: int(2 * SERIAL_HZ)] = 1.6
    # ecg: beat train at a subject-specific rate
    bpm = 62 + 2 * (subject % 7)
    ecg = rng.normal(0, 0.02, n)
    # the beat wave must hold the TOP ~20 % of samples (the detector
    # thresholds at a rolling 0.8-quantile): a ~0.25 s raised cosine per
    # ~1 s period puts exactly the beat lobes above that quantile
    beat_w = int(0.25 * SERIAL_HZ)
    bump = np.hanning(beat_w) * 3.0
    for b in np.arange(0, n - beat_w, 60.0 / bpm * SERIAL_HZ):
        b = int(b + rng.normal(0, 0.01 * SERIAL_HZ))
        if 0 <= b < n - beat_w:
            ecg[b:b + beat_w] += bump
    gsr = 2.0 + np.cumsum(rng.normal(0, 1e-3, n))
    times = qtc0() + pd.to_timedelta(t, unit="s")
    return pd.DataFrame({"fsr": fsr, "ecg": ecg, "gsr": gsr},
                        index=times)


def write_subject_tree(exp_root: Path, subject: int, plan: TrialPlan,
                       write_raw_serial: bool = True) -> Path:
    """Logs + questionnaires + per-trial accuracy for one subject."""
    import pandas as pd
    rng = np.random.default_rng(3000 + subject)
    sub = Path(exp_root) / f"subject_{subject:02}"
    (sub / "experiment_logs").mkdir(parents=True, exist_ok=True)
    (sub / "serial_measurements").mkdir(exist_ok=True)

    log = build_enriched_log(plan, subject)
    log.to_csv(sub / "experiment_logs" / filemgmt.file_title(
        "Enriched Experiment Log", ".csv"), index=False)

    if write_raw_serial:
        synth_raw_serial(plan, subject).to_csv(
            sub / "serial_measurements" / filemgmt.file_title(
                "Serial Measurements Final Save", ".csv"))

    onboarding = {
        "Name": "Anonymous", "Birthdate": "2000-01-01",
        "Gender": ["female", "male", "diverse"][subject % 3],
        "Dominant hand": "Right",
        "Listening habit": ["Most of the day", "A small part of the day",
                            "Every 2 or 3 days", "Seldom"][subject % 4],
        "Dancing habit": int(rng.integers(0, 8)),
        "Athleticism": int(rng.integers(0, 8)),
        "Musical skill": int(rng.integers(0, 8)),
    }
    with open(sub / filemgmt.file_title("Subject Data", ".json"),
              "w") as f:
        json.dump(onboarding, f, indent=2)
    with open(sub / filemgmt.file_title("Post-Study Feedback Data",
                                        ".json"), "w") as f:
        json.dump({"Total fatigue": int(rng.integers(1, 6)),
                   "Total pleasure": int(rng.integers(1, 6))}, f,
                  indent=2)

    n_acc = int(TRIAL_SEC * 10)
    for tr in plan.trials:
        name = (f"song_{tr['song_id']:03}" if tr["is_music"]
                else f"silence_{tr['silence_id']:03}")
        tdir = sub / name
        tdir.mkdir(exist_ok=True)
        mean_err = 170.0 if tr["is_music"] else 200.0
        err = rng.normal(mean_err, 40.0, n_acc) ** 2
        pd.DataFrame({"Squared Error": err}).to_csv(
            tdir / filemgmt.file_title("Trial Accuracy Results", ".csv"))
    return sub
