"""The driver-facing bench output contract.

The driver tail-captures ~2000 chars of stdout and parses the final
line as JSON; a record was once lost because the line grew to 6.3 KB.
These tests pin the contract: the final line always parses, always
stays under the budget, and the stable primary metrics survive even
worst-case trimming.
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import bench  # noqa: E402


def _representative_extras():
    """Extras shaped like a full run (illustrative values, not a
    measurement), with all three nested stage dicts present."""
    return {
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
        "cpu_spectra_per_sec_live": 942.1,
        "cpu_spectra_per_sec_pinned": 958.3,
        "full_cohort_10k_null_sec_single_device": 3.61,
        "full_cohort_10k_null_stages": {
            "quantize_sec": 0.21, "upload_coeffs_overlap_sec": 1.77,
            "upload_bytes": 47185920, "coeffs_sec": 1.31,
            "null_sec": 0.63,
        },
        "full_cohort_10k_null_cpu_sec_pinned": 241920.0,
        "full_cohort_10k_null_study_scale_sec_single_device": 10.59,
        "full_cohort_10k_null_study_scale_stages": {
            "task_signal_min_per_subject": 22.0,
            "n_task_windows_per_subject": 1320,
            "upload_sec": 7.61, "upload_bytes": 207028224,
            "coeffs_sec": 9.56, "null_sec": 1.03,
        },
        "compute_only_spectra_per_sec_device": 1432718.4,
        "compute_only_vs_cpu_pinned": 1495.1,
        "single_pair_10k_null_stages": {
            "upload_sec": 0.09, "observed_sec": 0.41, "null_sec": 6.87,
        },
        "single_pair_10k_null_sec_wall": 7.37,
        "preprocessing_channel_samples_per_sec_device": 102000000.0,
        "preprocessing_upload_sec": 1.52,
        "null_power_max_gap_auto": 0.0,
        "null_power_max_gap_rotation_arm": 0.45,
    }


def test_final_line_parses_and_fits_budget():
    line = bench.render_final_line(115702.0, 958.3,
                                   _representative_extras())
    assert len(line) <= bench.MAX_FINAL_LINE_CHARS, len(line)
    rec = json.loads(line)
    assert rec["metric"] == "cmc_spectra_per_sec_per_device"
    assert rec["value"] == 115702.0
    ex = rec["extras"]
    # the stable regression metric must be in the parsed record
    assert ex["compute_only_spectra_per_sec_device"] == 1432718.4
    assert ex["full_cohort_10k_null_study_scale_sec_single_device"] == 10.59
    assert not any(k.endswith(("_projected", "_link_model")) for k in ex)


def test_oversized_extras_trimmed_not_broken():
    ex = _representative_extras()
    # the old failure mode: a whole artifact file in extras
    ex["pipeline_five_stage_pinned"] = {
        f"stage_{i}": {"detail": "x" * 50, "sec": i} for i in range(40)}
    line = bench.render_final_line(115702.0, 958.3, ex)
    assert len(line) <= bench.MAX_FINAL_LINE_CHARS, len(line)
    rec = json.loads(line)
    # nested dicts dropped, scalars survive
    assert "pipeline_five_stage_pinned" not in rec["extras"]
    assert rec["extras"]["compute_only_spectra_per_sec_device"] \
        == 1432718.4


def test_pathological_extras_keep_primary_scalars():
    ex = {f"k{i}": float(i) for i in range(400)}
    ex["compute_only_spectra_per_sec_device"] = 1.0
    ex["failed_phases"] = "config-5"
    line = bench.render_final_line(1.0, 1.0, ex)
    assert len(line) <= bench.MAX_FINAL_LINE_CHARS
    rec = json.loads(line)
    assert rec["extras"]["compute_only_spectra_per_sec_device"] == 1.0
    assert rec["extras"]["failed_phases"] == "config-5"


def test_failed_phase_exits_non_zero(monkeypatch, capsys):
    """A phase that raises is logged, recorded in the final line, and
    turns the exit code non-zero; nothing is read from removed records."""
    monkeypatch.setattr(bench, "SECONDS", 8.0)
    monkeypatch.setattr(bench, "device_rate", lambda e, m: (10.0, 1.0, 7))
    monkeypatch.setattr(bench, "cpu_reference_rate", lambda e, m: (1.0, 2.0))

    def ok(*a, **k):
        return (1.0, 1.0, 1.0)

    def boom(*a, **k):
        raise RuntimeError("phase broke")
    for name in ("device_compute_only_rate", "batched_preprocessing_rate"):
        monkeypatch.setattr(bench, name, ok)
    for name in ("full_cohort_10k_null", "full_cohort_10k_null_study_scale",
                 "surrogate_null_wall", "single_pair_pipeline_wall",
                 "cohort_permutation_rate", "batched_lme_rate"):
        monkeypatch.setattr(bench, name, boom)
    assert bench.main() == 1
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "config-5" in rec["extras"]["failed_phases"]
    assert rec["extras"]["device"]["platform"] == "cpu"
