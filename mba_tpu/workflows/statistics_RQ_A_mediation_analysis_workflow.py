"""RQ-A mediation: do biosignal/emotion variables mediate the
category→CMC effects?

Parity target: reference
``src/statistics_RQ_A_mediation_analysis_workflow.py`` (858 LoC) — the
model/bootstrap/FDR/join/table machinery lives in
:mod:`mba_tpu.models.mediation` (batched bootstrap on the device); this workflow
wires the study configuration (:651-856).
"""
from __future__ import annotations

from pathlib import Path

import pandas as pd

from mba_tpu.models.mediation import (
    fetch_mediation_hypotheses, fit_mediation_model,
    bootstrap_indirect_effect, apply_fdr_and_enrich,
    join_omnibus_direct_effects, extract_report_ready_mediation_table,
    LEVEL1_X_VAR)
from mba_tpu.utils import file_management as filemgmt


def run_mediation_analysis(feature_data_dir: Path,
                           omnibus_results_path: Path | None,
                           output_dir: Path,
                           n_bootstrap: int = 2000,
                           n_segments: int = 1,
                           hypotheses=None,
                           fit_kwargs: dict | None = None) -> pd.DataFrame:
    """All (mediator × contrast × outcome) configurations + bootstrap."""
    output_dir = Path(output_dir)
    filemgmt.assert_dir(output_dir)
    data = pd.read_csv(filemgmt.most_recent_file(
        feature_data_dir, ".csv",
        [f"Combined Statistics {n_segments}seg"]))
    hypotheses = hypotheses or fetch_mediation_hypotheses()

    rows = []
    for hyp in hypotheses:
        for contrast in hyp["x_contrasts"]:
            for outcome in hyp["y_vars"]:
                fit = fit_mediation_model(
                    data, hyp["x_var"], contrast, hyp["m_var"], outcome,
                    **(fit_kwargs or {}))
                boot = bootstrap_indirect_effect(
                    fit, n_bootstrap=n_bootstrap)
                rows.append({**{k: v for k, v in fit.items()
                                if k != "model_df"}, **boot})
    results = pd.DataFrame(rows)
    results = apply_fdr_and_enrich(results)

    if omnibus_results_path is not None:
        omnibus = pd.read_csv(omnibus_results_path)
        results = join_omnibus_direct_effects(results, omnibus,
                                              n_segments=n_segments)

    results.to_csv(output_dir / filemgmt.file_title(
        "Mediation Analysis Raw Results", ".csv"), index=False)
    table = extract_report_ready_mediation_table(results)
    table.to_csv(output_dir / filemgmt.file_title(
        "Mediation Analysis Report Table", ".csv"), index=False)
    print(f"Mediation: {len(results)} configs, "
          f"{int(results.get('significant', pd.Series()).sum() or 0)} "
          f"significant indirect effects")
    return results


if __name__ == "__main__":
    from mba_tpu.workflows.paths import StudyPaths

    n_bootstrap = 2000   # the reference capped at 300: 'drives runtime!'
    paths = StudyPaths().ensure()
    try:
        omnibus_path = filemgmt.most_recent_file(
            paths.statistics_rq_a, ".csv",
            ["All Time Resolutions Results"])
    except ValueError:
        omnibus_path = None
    run_mediation_analysis(paths.feature_data, omnibus_path,
                           paths.statistics_rq_a_post_hoc,
                           n_bootstrap=n_bootstrap)
