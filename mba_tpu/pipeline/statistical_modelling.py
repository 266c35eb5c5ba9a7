"""Inferential engine: OLS + random-intercept LME with Kish design effects.

Parity target: reference ``src/pipeline/statistical_modelling.py`` (2737
LoC).  Public API and result-frame schemas preserved exactly; the solvers
are native (:mod:`mba_tpu.models`), and the simulation-heavy robustness
machinery (power analysis, LOSO) batches thousands of REML refits on the
the device via :func:`mba_tpu.models.lme.batched_lme_pvalues` — the reference
marks these "very run-time extensive" (BASELINE.md).

Key symbols (reference line refs):
- :func:`fit_linear_regression_model`    ↔ :75-374
- :func:`fit_mixed_effects_model`        ↔ :379-865
- :func:`fit_both_models`                ↔ :874-945
- :func:`apply_fdr_correction`           ↔ :948-1046
- :func:`store_model_results`            ↔ :1049-1162
- :func:`create_subject_effect_summary`  ↔ :1170-1370
- :func:`run_model_levels`               ↔ :1787-1873
- :func:`run_influence_analysis` (LOSO)  ↔ :1941-2246
- :class:`PowerConfig` / :func:`run_power_analysis` ↔ :2256-2737
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import pandas as pd
from scipy import stats

from mba_tpu.models.formula import (apply_reference_categories,
                                    build_design_matrix, build_formula)
from mba_tpu.models.ols import fit_ols
from mba_tpu.models.lme import (fit_random_intercept_reml,
                                batched_lme_pvalues)
from mba_tpu.models.fdr import benjamini_hochberg
from mba_tpu.utils import file_management as filemgmt

_apply_reference_categories = apply_reference_categories  # reference name


# ──────────────────────────────────────────────────────────────────────────
# shared helpers
# ──────────────────────────────────────────────────────────────────────────
def _coerce_dtypes(df: pd.DataFrame, response_var: str,
                   condition_vars: dict, explanatory_vars: list
                   ) -> pd.DataFrame:
    df[response_var] = pd.to_numeric(df[response_var], errors="coerce")
    for var in explanatory_vars:
        if var not in condition_vars:
            df[var] = pd.to_numeric(df[var], errors="coerce")
    for var_name, var_type in condition_vars.items():
        if var_type == "categorical":
            df[var_name] = df[var_name].astype("category")
        elif var_type == "ordinal":
            df[var_name] = pd.to_numeric(df[var_name], errors="coerce")
    return df


def _kish_design_effect(residuals: np.ndarray, df: pd.DataFrame,
                        grouping_var: str,
                        autocorr_threshold: float) -> dict:
    """Two-level Kish design effect (reference :235-299 / :577-655).

    deff_between from trial-level lag-1 ρ of trial-mean residuals;
    deff_within from pooled within-trial segment lag-1 ρ (multi-segment
    frames only); combined deff = deff_between · deff_within.
    """
    resid = pd.Series(residuals, index=df.index)
    lag1 = np.corrcoef(residuals[:-1], residuals[1:])[0, 1] \
        if len(residuals) > 2 else np.nan
    lag1 = 0.0 if np.isnan(lag1) else float(lag1)

    if "Trial ID" in df.columns:
        trial_resid = resid.groupby(df["Trial ID"]).mean()
        if len(trial_resid) > 2:
            rho_raw = np.corrcoef(trial_resid.values[:-1],
                                  trial_resid.values[1:])[0, 1]
        else:
            rho_raw = np.nan
        rho_between = 0.0 if np.isnan(rho_raw) else float(rho_raw)
        n_trials = float(df.groupby(grouping_var)["Trial ID"].nunique()
                         .mean())
    else:
        rho_between = lag1
        n_trials = len(df) / max(df[grouping_var].nunique(), 1)

    deff_between = (1.0 if abs(rho_between) < autocorr_threshold
                    else 1 + (n_trials - 1) * max(0.0, rho_between))

    has_segments = "Segment ID" in df.columns and "Trial ID" in df.columns
    n_segments = int(df["Segment ID"].nunique()) if has_segments else 1
    rho_within, deff_within = 0.0, 1.0
    if has_segments and n_segments > 1:
        within = []
        for _, grp in resid.groupby(df["Trial ID"]):
            vals = grp.sort_index().values
            if len(vals) > 1:
                r = np.corrcoef(vals[:-1], vals[1:])[0, 1]
                if not np.isnan(r):
                    within.append(r)
        rho_within = float(np.mean(within)) if within else 0.0
        if abs(rho_within) >= autocorr_threshold:
            deff_within = 1 + (n_segments - 1) * max(0.0, rho_within)

    design_effect = deff_between * deff_within
    return {
        "lag1_autocorr": lag1, "rho_for_deff": rho_between,
        "rho_within_trial": rho_within, "deff_between": deff_between,
        "deff_within": deff_within, "n_segments_per_trial": n_segments,
        "n_trials_per_subject": n_trials,
        "design_effect": design_effect,
        "se_inflation": float(np.sqrt(design_effect)),
        "inflation_applied": design_effect > 1.0,
    }


def _sentinel_rows(residual_std: float, re_std: float) -> list[dict]:
    rows = []
    for name, value in (("__residual_std__", residual_std),
                        ("__re_std__", re_std)):
        rows.append({"Parameter": name, "Coefficient": float(value),
                     "SE (unadjusted)": np.nan, "SE (adjusted)": np.nan,
                     "p-value (unadjusted)": np.nan,
                     "p-value (adjusted)": np.nan})
    return rows


# ──────────────────────────────────────────────────────────────────────────
# OLS  (reference :75-374)
# ──────────────────────────────────────────────────────────────────────────
def fit_linear_regression_model(df: pd.DataFrame, response_var: str,
                                condition_vars: dict,
                                explanatory_vars: list,
                                show_diagnostic_plots: bool = False,
                                autocorr_threshold: float = 0.1,
                                moderation_pairs: list | None = None,
                                reference_categories: dict | None = None,
                                verbose: bool = True) -> dict:
    """OLS with two-level Kish SE inflation and variance sentinels."""
    df = df.copy()
    df = _coerce_dtypes(df, response_var, condition_vars, explanatory_vars)
    cols = ([response_var, "Subject ID"] + list(condition_vars)
            + explanatory_vars)
    df = df.dropna(subset=[c for c in cols if c in df.columns])

    X, names = build_design_matrix(df, condition_vars, explanatory_vars,
                                   moderation_pairs, reference_categories)
    formula = build_formula(response_var, condition_vars, explanatory_vars,
                            moderation_pairs)
    if verbose:
        print(f"\n[OLS] Formula: {formula}  "
              f"({len(df)} obs, {df['Subject ID'].nunique()} subjects)")

    fit = fit_ols(X, df[response_var].to_numpy())
    residuals = fit["resid"]
    shapiro_stat, shapiro_p = (stats.shapiro(residuals)
                               if 3 <= len(residuals) <= 5000
                               else stats.shapiro(
                                   np.random.default_rng(0).choice(
                                       residuals, 5000, replace=False)))

    deff = _kish_design_effect(residuals, df, "Subject ID",
                               autocorr_threshold)
    se_inf = deff["se_inflation"] if deff["inflation_applied"] else 1.0
    adjusted_se = fit["bse"] * se_inf
    with np.errstate(divide='ignore', invalid='ignore'):
        adjusted_z = np.where(adjusted_se > 0, fit["params"] / adjusted_se,
                              np.nan)
    adjusted_p = 2 * (1 - stats.norm.cdf(np.abs(adjusted_z)))

    results_data = [{
        "Parameter": param, "Coefficient": fit["params"][i],
        "SE (unadjusted)": fit["bse"][i], "SE (adjusted)": adjusted_se[i],
        "p-value (unadjusted)": fit["pvalues"][i],
        "p-value (adjusted)": adjusted_p[i],
    } for i, param in enumerate(names)]

    # between/within variance decomposition → power-analysis sentinels
    subj_mean_resid = pd.Series(residuals, index=df.index).groupby(
        df["Subject ID"]).mean()
    var_between = (float(np.var(subj_mean_resid, ddof=1))
                   if len(subj_mean_resid) > 1 else 0.0)
    var_within = max(float(fit["mse_resid"]) - var_between, 0.0)
    results_data += _sentinel_rows(np.sqrt(var_within),
                                   np.sqrt(max(var_between, 0.0)))

    diagnostics = {
        "n_observations": len(df),
        "n_trials_per_subject": deff["n_trials_per_subject"],
        "shapiro_stat": float(shapiro_stat), "shapiro_p": float(shapiro_p),
        **{k: deff[k] for k in ("lag1_autocorr", "rho_for_deff",
                                "rho_within_trial", "deff_between",
                                "deff_within", "n_segments_per_trial",
                                "design_effect", "se_inflation",
                                "inflation_applied")},
        "autocorr_threshold": autocorr_threshold,
        "r_squared": fit["rsquared"], "r_squared_adj": fit["rsquared_adj"],
        "residual_std": float(np.sqrt(var_within)),
        "total_residual_std": float(np.sqrt(fit["mse_resid"])),
        "icc": None,
    }
    return {"model": fit, "results_df": pd.DataFrame(results_data),
            "diagnostics": diagnostics}


# ──────────────────────────────────────────────────────────────────────────
# LME  (reference :379-865)
# ──────────────────────────────────────────────────────────────────────────
def fit_mixed_effects_model(df: pd.DataFrame, response_var: str,
                            condition_vars: dict, explanatory_vars: list,
                            grouping_var: str = "Subject ID",
                            show_diagnostic_plots: bool = False,
                            autocorr_threshold: float = 0.1,
                            moderation_pairs: list | None = None,
                            reference_categories: dict | None = None,
                            verbose: bool = True) -> dict | None:
    """Random-intercept REML LME; returns None for rank-deficient designs
    (caller must handle None, as in the reference)."""
    df = df.copy()
    df = _coerce_dtypes(df, response_var, condition_vars, explanatory_vars)
    cols = ([response_var, grouping_var] + list(condition_vars)
            + explanatory_vars)
    df = df.dropna(subset=[c for c in cols if c in df.columns])

    X, names = build_design_matrix(df, condition_vars, explanatory_vars,
                                   moderation_pairs, reference_categories)
    formula = build_formula(response_var, condition_vars, explanatory_vars,
                            moderation_pairs)
    if verbose:
        print(f"\n[LME] Formula: {formula} | random intercept by "
              f"{grouping_var} ({len(df)} obs, "
              f"{df[grouping_var].nunique()} groups)")

    rank = np.linalg.matrix_rank(X)
    if rank < X.shape[1]:
        print(f"  [WARN] Rank-deficient design matrix: rank={rank}, "
              f"n_params={X.shape[1]} "
              f"({X.shape[1] - rank} redundant columns). Skipping LME fit.")
        return None
    try:
        result = fit_random_intercept_reml(
            X, df[response_var].to_numpy(),
            df[grouping_var].to_numpy(), names)
    except np.linalg.LinAlgError as e:
        print(f"  [WARN] LME singular matrix: {e}. Skipping.")
        return None

    residuals = result["resid"]
    shapiro_stat, shapiro_p = stats.shapiro(
        residuals if len(residuals) <= 5000
        else np.random.default_rng(0).choice(residuals, 5000,
                                              replace=False))

    deff = _kish_design_effect(residuals, df, grouping_var,
                               autocorr_threshold)
    se_inf = deff["se_inflation"] if deff["inflation_applied"] else 1.0
    adjusted_se = result["bse"] * se_inf
    with np.errstate(divide='ignore', invalid='ignore'):
        adjusted_z = np.where(adjusted_se > 0,
                              result["params"] / adjusted_se, np.nan)
    adjusted_p = 2 * (1 - stats.norm.cdf(np.abs(adjusted_z)))

    results_data = [{
        "Parameter": param, "Coefficient": result["params"][i],
        "SE (unadjusted)": result["bse"][i],
        "SE (adjusted)": adjusted_se[i],
        "p-value (unadjusted)": result["pvalues"][i],
        "p-value (adjusted)": adjusted_p[i],
    } for i, param in enumerate(names)]

    re_var = result["cov_re"]
    results_data += _sentinel_rows(np.sqrt(result["scale"]),
                                   np.sqrt(max(re_var, 0.0)))
    results_df = pd.DataFrame(results_data)

    random_effects_df = pd.DataFrame([
        {grouping_var: group, 'Random Intercept': b}
        for group, b in result["random_effects"].items()])

    # Nakagawa–Schielzeth R² + random-intercept ICC (reference :747-767)
    var_fixed = float(np.var(X @ result["params"]))
    var_random = max(re_var, 0.0)
    var_resid = result["scale"]
    total = var_fixed + var_random + var_resid
    r2_marginal = var_fixed / total if total > 0 else None
    r2_conditional = ((var_fixed + var_random) / total
                      if total > 0 else None)
    denom_icc = var_random + var_resid
    icc = float(var_random / denom_icc) if denom_icc > 0 else None

    diagnostics = {
        "n_observations": len(df),
        "shapiro_stat": float(shapiro_stat), "shapiro_p": float(shapiro_p),
        **{k: deff[k] for k in ("lag1_autocorr", "rho_for_deff",
                                "rho_within_trial", "deff_between",
                                "deff_within", "n_segments_per_trial",
                                "design_effect", "se_inflation")},
        "n_trials_per_subj": deff["n_trials_per_subject"],
        "log_likelihood": result["llf"], "aic": result["aic"],
        "bic": result["bic"],
        "r_squared_marginal": r2_marginal,
        "r_squared_conditional": r2_conditional,
        "residual_std": float(np.sqrt(result["scale"])),
        "total_residual_std": float(np.sqrt(result["scale"]
                                            + max(re_var, 0.0))),
        "icc": icc,
    }
    return {"model": result, "result": result, "results_df": results_df,
            "random_effects_df": random_effects_df,
            "diagnostics": diagnostics}


def fit_both_models(df: pd.DataFrame, response_var: str,
                    condition_vars: dict, explanatory_vars: list,
                    comparison_level_name: str, hypothesis_name: str,
                    n_windows_per_trial: int = 9,
                    show_diagnostic_plots: bool = False,
                    reference_categories: dict | None = None,
                    moderation_pairs: list | None = None,
                    verbose: bool = True,
                    models: tuple = ("OLS", "LME")) -> dict:
    """Fit OLS + LME (reference :874-945).

    ``models`` restricts which engines run — the LOSO influence path
    consumes only the OLS rows (``_compute_influence`` merges on
    Model_Type == 'OLS'), so its n_subjects refit loop requests
    ``('OLS',)`` and skips the iterative REML fit entirely.
    """
    if verbose:
        print("\n" + "=" * 80)
        print(f"HYPOTHESIS: {hypothesis_name} | DV: {response_var} | "
              f"LEVEL: {comparison_level_name}")
        print("=" * 80)
    out = {}
    if "OLS" in models:
        out["OLS"] = fit_linear_regression_model(
            df=df, response_var=response_var,
            condition_vars=condition_vars,
            explanatory_vars=explanatory_vars,
            show_diagnostic_plots=show_diagnostic_plots,
            moderation_pairs=moderation_pairs,
            reference_categories=reference_categories, verbose=verbose)
    if "LME" in models:
        out["LME"] = fit_mixed_effects_model(
            df=df, response_var=response_var,
            condition_vars=condition_vars,
            explanatory_vars=explanatory_vars,
            grouping_var="Subject ID",
            show_diagnostic_plots=show_diagnostic_plots,
            moderation_pairs=moderation_pairs,
            reference_categories=reference_categories, verbose=verbose)
    return out


# ──────────────────────────────────────────────────────────────────────────
# FDR + accumulation  (reference :948-1162)
# ──────────────────────────────────────────────────────────────────────────
def apply_fdr_correction(results_df: pd.DataFrame,
                         levels_to_correct: list[int],
                         alpha: float = 0.05,
                         group_by_dv: bool = True) -> pd.DataFrame:
    """BH-FDR per (Level × N. Segments × Model_Type [× DV]) stratum."""
    df = results_df.copy()
    df["p_value_fdr"] = np.nan
    df["significant_fdr"] = False

    _SENTINEL = {"__residual_std__", "__re_std__"}
    eligible_mask = (
        df["Parameter"].apply(lambda p: p not in _SENTINEL
                              and not str(p).startswith("Intercept"))
        & df["Comparison_Level"].apply(
            lambda lvl: any(str(lvl).startswith(f"Level {i} ")
                            for i in levels_to_correct)))
    if not eligible_mask.any():
        print("  [FDR] No eligible rows found for the specified levels.")
        df["p_value_for_plot"] = df["p_value_fdr"].fillna(
            df["p_value_adjusted"])
        return df

    eligible = df[eligible_mask]
    group_cols = ["Comparison_Level", "N. Segments", "Model_Type"]
    if group_by_dv:
        group_cols.append("Dependent_Variable")

    n_corrected = 0
    for _, grp in eligible.groupby(group_cols):
        p_vals = grp["p_value_adjusted"].values
        valid = ~np.isnan(p_vals)
        if valid.sum() < 2:
            continue
        reject, p_fdr = benjamini_hochberg(p_vals[valid], alpha=alpha)
        idx = grp.index[valid]
        df.loc[idx, "p_value_fdr"] = p_fdr
        df.loc[idx, "significant_fdr"] = reject
        n_corrected += int(valid.sum())

    n_sig_after = int(df.loc[eligible_mask, "significant_fdr"].sum())
    print(f"  [FDR] BH correction: {n_corrected} parameters corrected; "
          f"{n_sig_after} significant at alpha_FDR={alpha}")
    df["p_value_for_plot"] = df["p_value_fdr"].fillna(
        df["p_value_adjusted"])
    return df


def store_model_results(model_results: dict, hypothesis_name: str,
                        dependent_variable: str,
                        comparison_level_name: str,
                        all_results_list: list,
                        diagnostics_list: list | None = None) -> None:
    """One row per parameter (incl. Cohen's d = β / total residual SD)."""
    _SENTINEL_PARAMS = {"__residual_std__", "__re_std__"}
    for model_type in ["OLS", "LME"]:
        model_out = model_results.get(model_type)
        if model_out is None:
            continue
        diag = model_out.get("diagnostics", {})
        residual_std = diag.get("total_residual_std", None)

        for _, row in model_out["results_df"].iterrows():
            param = row["Parameter"]
            cohens_d = None
            if (residual_std and residual_std > 0
                    and param not in _SENTINEL_PARAMS
                    and param != "Intercept"):
                cohens_d = float(row["Coefficient"]) / residual_std
            all_results_list.append({
                "Hypothesis": hypothesis_name,
                "Dependent_Variable": dependent_variable,
                "Model_Type": model_type,
                "Comparison_Level": comparison_level_name,
                "Parameter": param,
                "Coefficient": row["Coefficient"],
                "SE_unadjusted": row["SE (unadjusted)"],
                "SE_adjusted": row["SE (adjusted)"],
                "p_value_unadjusted": row["p-value (unadjusted)"],
                "p_value_adjusted": row["p-value (adjusted)"],
                "p_value": row["p-value (adjusted)"],
                "SE": row["SE (adjusted)"],
                "Cohen_d": cohens_d,
            })

        if diagnostics_list is not None and diag:
            diagnostics_list.append({
                "Hypothesis": hypothesis_name,
                "Dependent_Variable": dependent_variable,
                "Model_Type": model_type,
                "Comparison_Level": comparison_level_name,
                "N_Observations": diag.get("n_observations"),
                "Shapiro_p": diag.get("shapiro_p"),
                "Shapiro_Violated": "Yes" if diag.get("shapiro_p", 1.0)
                < 0.05 else "No",
                "Lag1_Autocorr": diag.get("lag1_autocorr"),
                "Design_Effect": diag.get("design_effect"),
                "SE_Inflation": diag.get("se_inflation"),
                "R_squared": diag.get("r_squared"),
                "R_squared_adj": diag.get("r_squared_adj"),
                "AIC": diag.get("aic"), "BIC": diag.get("bic"),
                "LogLik": diag.get("log_likelihood"),
                "R_squared_marginal": diag.get("r_squared_marginal"),
                "R_squared_conditional": diag.get("r_squared_conditional"),
                "ICC": diag.get("icc"),
            })


# ──────────────────────────────────────────────────────────────────────────
# level runner  (reference :1787-1916)
# ──────────────────────────────────────────────────────────────────────────
def _build_level_name(level_idx: int, condition_vars: dict,
                      explanatory_vars: list,
                      moderation_pairs: list | None) -> str:
    def _short(name: str) -> str:
        name = name.replace('_centered', '')
        name = name.split('[')[0].strip()
        return {'Median Force Level': 'Force',
                'Median Heart Rate': 'Heart Rate',
                'Median HRV': 'HRV'}.get(name, name)

    parts = [_short(v) for v in condition_vars] + \
        [_short(v) for v in explanatory_vars]
    seen, unique_parts = set(), []
    for p in parts:
        if p not in seen:
            seen.add(p)
            unique_parts.append(p)
    label = ' + '.join(unique_parts)
    if moderation_pairs:
        label += ' + Interactions'
    return f"Level {level_idx} ({label})"


def run_model_levels(base_df: pd.DataFrame, level_definitions: list[dict],
                     response_var: str, hypothesis_name: str,
                     n_windows_per_trial: int, all_results_list: list,
                     diagnostics_list: list,
                     levels_to_include: list[int] | None = None,
                     show_diagnostic_plots: bool = False,
                     verbose: bool = True,
                     models: tuple = ("OLS", "LME")) -> None:
    """Fit both models for each comparison level and accumulate results."""
    if levels_to_include is None:
        levels_to_include = list(range(len(level_definitions)))
    for level_idx, level_def in enumerate(level_definitions):
        if level_idx not in levels_to_include:
            continue
        df_filter = level_def.get('df_filter', None)
        df = df_filter(base_df) if df_filter is not None else base_df
        condition_vars = level_def['condition_vars']
        reference_categories = level_def.get('reference_categories', None)
        explanatory_vars = level_def['explanatory_vars']
        moderation_pairs = level_def.get('moderation_pairs', None)
        comparison_level_name = _build_level_name(
            level_idx, condition_vars, explanatory_vars, moderation_pairs)
        results = fit_both_models(
            df=df, response_var=response_var,
            condition_vars=condition_vars,
            reference_categories=reference_categories,
            explanatory_vars=explanatory_vars,
            comparison_level_name=comparison_level_name,
            hypothesis_name=hypothesis_name,
            n_windows_per_trial=n_windows_per_trial,
            show_diagnostic_plots=show_diagnostic_plots, verbose=verbose,
            models=models)
        store_model_results(results, hypothesis_name, response_var,
                            comparison_level_name, all_results_list,
                            diagnostics_list)


# ──────────────────────────────────────────────────────────────────────────
# subject-level contrasts  (reference :1170-1370)
# ──────────────────────────────────────────────────────────────────────────
def create_subject_effect_summary(all_model_results: list,
                                  original_data: pd.DataFrame,
                                  output_dir: Path,
                                  level_definitions: list[dict],
                                  subject_col: str = "Subject ID",
                                  save_pivot_tables: bool = False
                                  ) -> pd.DataFrame:
    """Per-subject marginal summaries + per-level condition contrasts with
    responder flags and normalised contrasts."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    results_df = pd.DataFrame(all_model_results)
    if "Parameter" in results_df.columns:
        results_df = results_df[~results_df["Parameter"].astype(str)
                                .str.startswith("__")]
    lme_results = results_df[results_df["Model_Type"] == "LME"]

    join_keys = ["Hypothesis", "Dependent_Variable", subject_col]
    subject_summaries, contrast_summaries = [], []
    for hypothesis in lme_results["Hypothesis"].dropna().unique():
        hyp = lme_results[lme_results["Hypothesis"] == hypothesis]
        for dv in hyp["Dependent_Variable"].dropna().unique():
            for subject_id in sorted(
                    original_data[subject_col].dropna().unique()):
                subj_all = original_data[
                    (original_data[subject_col] == subject_id)
                    & original_data[dv].notna()]
                if subj_all.empty:
                    continue
                subject_summaries.append({
                    "Hypothesis": hypothesis, "Dependent_Variable": dv,
                    subject_col: subject_id,
                    "Marginal_Mean": float(subj_all[dv].mean()),
                    "Marginal_Std": float(subj_all[dv].std()),
                    "N_Observations": int(len(subj_all))})
                for level_idx, level_def in enumerate(level_definitions):
                    comp_level = f"lvl_{level_idx}"
                    subj_lvl = subj_all
                    if level_def.get("df_filter") is not None:
                        try:
                            subj_lvl = level_def["df_filter"](subj_all)
                        except Exception:
                            continue
                    subj_lvl = subj_lvl[subj_lvl[dv].notna()]
                    if subj_lvl.empty:
                        continue
                    for var_name, var_type in level_def.get(
                            "condition_vars", {}).items():
                        if (var_type != "categorical"
                                or var_name not in subj_lvl.columns):
                            continue
                        for condition in subj_lvl[var_name].dropna(
                                ).unique():
                            cond = subj_lvl[subj_lvl[var_name]
                                            == condition]
                            if cond.empty:
                                continue
                            contrast_summaries.append({
                                "Hypothesis": hypothesis,
                                "Dependent_Variable": dv,
                                subject_col: subject_id,
                                "Comparison_Level": comp_level,
                                "Condition_Variable": var_name,
                                "Condition": condition,
                                "Condition_Mean": float(cond[dv].mean()),
                                "Condition_Std": float(cond[dv].std()),
                                "N": int(len(cond))})

    if not subject_summaries or not contrast_summaries:
        print("[WARN] No summaries generated — returning empty frame.")
        return pd.DataFrame()

    marginal_df = pd.DataFrame(subject_summaries)
    combined = pd.DataFrame(contrast_summaries).merge(
        marginal_df[join_keys + ["Marginal_Mean", "Marginal_Std",
                                 "N_Observations"]],
        on=join_keys, how="left")

    ref_map = {"Category or Silence": "Silence",
               "Music Listening": False,
               "Perceived Category": "Classic"}
    combined["Reference_Condition"] = combined["Condition_Variable"].map(
        ref_map)
    ref_keys = join_keys + ["Comparison_Level", "Condition_Variable"]
    ref_mask = (combined["Reference_Condition"].notna()
                & (combined["Condition"]
                   == combined["Reference_Condition"]))
    ref_means = (combined.loc[ref_mask, ref_keys + ["Condition_Mean"]]
                 .rename(columns={"Condition_Mean": "Reference_Mean"})
                 .drop_duplicates(subset=ref_keys))
    combined = combined.merge(ref_means, on=ref_keys, how="left")
    combined["Raw_Contrast"] = (combined["Condition_Mean"]
                                - combined["Reference_Mean"])
    denom = combined["Marginal_Mean"].abs().replace({0.0: np.nan})
    combined["Normalised_Contrast"] = combined["Raw_Contrast"] / denom
    combined["Subject_CV"] = combined["Marginal_Std"] / denom
    combined["Responder_Flag"] = combined["Raw_Contrast"] > 0

    out = output_dir / filemgmt.file_title(
        "Subject Effect Summary Combined", ".csv")
    combined.to_csv(out, index=False)
    print(f"Saved combined subject summary -> {out} ({len(combined)} rows)")
    return combined


# ──────────────────────────────────────────────────────────────────────────
# LOSO influence  (reference :1941-2246)
# ──────────────────────────────────────────────────────────────────────────
def _run_loso(all_subject_df: pd.DataFrame, dep_var: str, comp_lvl: int,
              n_segments: int,
              fetch_level_definitions: Callable[[bool], list[dict]],
              run_model_levels_fn: Callable | None = None) -> pd.DataFrame:
    """Leave-one-subject-out refits for one config.

    Only the OLS rows feed the influence computation downstream
    (``_compute_influence`` merges on Model_Type == 'OLS'), so the
    n_subjects refit loop requests OLS only — the per-drop iterative
    REML fits the loop used to pay were never consumed.  A custom
    ``run_model_levels_fn`` without a ``models`` parameter (test
    doubles) still runs whatever it runs.
    """
    run_fn = run_model_levels_fn or run_model_levels
    extra = {}
    try:
        import inspect
        if "models" in inspect.signature(run_fn).parameters:
            extra["models"] = ("OLS",)
    except (TypeError, ValueError):
        pass
    frames = []
    for subject_id in all_subject_df["Subject ID"].dropna().unique():
        remaining = all_subject_df.loc[
            all_subject_df["Subject ID"] != subject_id]
        temp_results: list = []
        temp_diag: list = []
        run_fn(base_df=remaining,
               level_definitions=fetch_level_definitions(n_segments > 1),
               levels_to_include=[comp_lvl], response_var=dep_var,
               hypothesis_name=f"LOSO {dep_var} drop_{int(subject_id):02}",
               n_windows_per_trial=n_segments,
               all_results_list=temp_results,
               diagnostics_list=temp_diag, verbose=False, **extra)
        frame = pd.DataFrame(temp_results)
        frame["Dropped Subject ID"] = subject_id
        frames.append(frame)
    return pd.concat(frames, ignore_index=True)


def _compute_influence(loso_df: pd.DataFrame,
                       full_results_df: pd.DataFrame, dep_var: str,
                       comp_lvl: int, n_segments: int):
    """Cook's-D approximation + DFBETA pivot from LOSO results."""
    level_names = [lvl for lvl
                   in full_results_df["Comparison_Level"].unique()
                   if str(lvl).startswith(f"Level {comp_lvl} ")]
    full_ols = full_results_df.loc[
        (full_results_df["Model_Type"] == "OLS")
        & (full_results_df["Comparison_Level"].isin(level_names))
        & (full_results_df["N. Segments"] == n_segments)
        & (full_results_df["Dependent_Variable"] == dep_var),
        ["Parameter", "Coefficient", "SE"]].rename(
            columns={"Coefficient": "Coef_full", "SE": "SE_full"})
    loso_ols = loso_df[loso_df["Model_Type"] == "OLS"].copy()
    merged = loso_ols.merge(full_ols, on="Parameter", how="inner")
    merged["DFBETA"] = ((merged["Coef_full"] - merged["Coefficient"])
                        / merged["SE_full"])
    cooks = (merged.groupby("Dropped Subject ID")["DFBETA"]
             .apply(lambda x: np.mean(x ** 2)).rename(dep_var)
             .sort_values(ascending=False))
    pivot = merged.pivot_table(index="Parameter",
                               columns="Dropped Subject ID",
                               values="DFBETA")
    pivot.columns = pd.MultiIndex.from_tuples(
        [(dep_var, s) for s in pivot.columns],
        names=["Dependent Variable", "Dropped Subject ID"])
    return cooks, pivot


def run_influence_analysis(configs: list[tuple[str, int, int]],
                           full_results_df: pd.DataFrame,
                           feature_output_data: Path,
                           statistics_output_data: Path,
                           fetch_level_definitions: Callable,
                           run_model_levels=None,
                           file_title: Callable | None = None,
                           dfbeta_flag_threshold: float = 1.0,
                           cooks_flag_threshold: float | None = None,
                           df_transform: Callable | None = None
                           ) -> pd.DataFrame:
    """LOSO influence analysis: DFBETA + Cook's D long table."""
    file_title = file_title or filemgmt.file_title
    all_rows = []
    for dep_var, comp_lvl, n_segments in configs:
        print(f"Influence analysis | DV: {dep_var} | Level: {comp_lvl} | "
              f"Segments: {n_segments}")
        all_subject_df = pd.read_csv(filemgmt.most_recent_file(
            feature_output_data, ".csv",
            [f"Combined Statistics {n_segments}seg"]))
        if df_transform is not None:
            all_subject_df = df_transform(all_subject_df)
        n_subjects = all_subject_df["Subject ID"].nunique()
        cooks_threshold = (cooks_flag_threshold
                           if cooks_flag_threshold is not None
                           else 4.0 / n_subjects)
        loso_df = _run_loso(all_subject_df, dep_var, comp_lvl, n_segments,
                            fetch_level_definitions, run_model_levels)
        cooks, pivot = _compute_influence(loso_df, full_results_df,
                                          dep_var, comp_lvl, n_segments)
        if pivot.empty or pivot.shape[1] == 0:
            print("  [WARN] empty influence pivot — skipping config.")
            continue
        flat = pivot.copy()
        flat.columns = [int(c) for c in flat.columns.droplevel(0)]
        long = (flat.rename_axis("Parameter").reset_index()
                .melt(id_vars="Parameter", var_name="Subject_ID",
                      value_name="DFBETA"))
        long["Subject_ID"] = long["Subject_ID"].astype(int)
        cooks_map = (cooks.rename("CooksD").rename_axis("Subject_ID")
                     .reset_index())
        cooks_map["Subject_ID"] = cooks_map["Subject_ID"].astype(int)
        long = long.merge(cooks_map, on="Subject_ID", how="left")
        long["DFBETA_Flagged"] = long["DFBETA"].abs() >= \
            dfbeta_flag_threshold
        long["CooksD_Flagged"] = long["CooksD"] >= cooks_threshold
        long["CooksD_Threshold"] = cooks_threshold
        long.insert(0, "Dependent_Variable", dep_var)
        long.insert(1, "Comparison_Level", comp_lvl)
        long.insert(2, "N_Segments", n_segments)
        all_rows.append(long)

    combined = pd.concat(all_rows, ignore_index=True)
    combined = combined[[
        "Dependent_Variable", "Comparison_Level", "N_Segments",
        "Parameter", "Subject_ID", "DFBETA", "DFBETA_Flagged",
        "CooksD", "CooksD_Flagged", "CooksD_Threshold"]]
    out_path = Path(statistics_output_data) / file_title(
        "Influence Analysis Combined", ".csv")
    combined.to_csv(out_path, index=False)
    print(f"Saved combined influence table -> {out_path} "
          f"({len(combined)} rows)")
    return combined


# ──────────────────────────────────────────────────────────────────────────
# power analysis  (reference :2256-2737) — batched on the device
# ──────────────────────────────────────────────────────────────────────────
@dataclass
class PowerConfig:
    """One power-analysis run (reference :2256-2295)."""
    dependent_var: str
    comp_lvl: int
    n_segments: int
    target_parameters: list[str]
    n_simulations: int = 500
    effect_multipliers: list[float] = field(
        default_factory=lambda: [0.25, 0.5, 0.75, 1.0, 1.25, 1.5, 2.0])
    target_power: float = 0.80
    alpha: float = 0.05
    random_seed: int = 42


def _extract_lme_params(results_df: pd.DataFrame, dep_var: str,
                        comp_lvl: int, n_segments: int) -> dict:
    """Generative parameters from the sentinel rows (reference :2302)."""
    level_names = [lvl for lvl in results_df["Comparison_Level"].unique()
                   if str(lvl).startswith(f"Level {comp_lvl} ")]
    mask = ((results_df["Model_Type"] == "LME")
            & (results_df["Comparison_Level"].isin(level_names))
            & (results_df["N. Segments"] == n_segments)
            & (results_df["Dependent_Variable"] == dep_var))
    subset = results_df.loc[mask]
    if subset.empty:
        raise ValueError(
            f"No saved LME results for DV='{dep_var}', Level {comp_lvl}, "
            f"{n_segments} segments.")

    def sentinel(key):
        row = subset.loc[subset["Parameter"] == key, "Coefficient"]
        if row.empty:
            raise KeyError(f"Sentinel '{key}' not found.")
        return float(row.iloc[0])

    residual_std = sentinel("__residual_std__")
    re_std = sentinel("__re_std__")
    params = subset[~subset["Parameter"].str.startswith("__")]
    fixed = dict(zip(params["Parameter"], params["Coefficient"]))
    return {"fixed_effects": fixed, "residual_std": residual_std,
            "re_std": re_std}


def _simulate_jobs_and_fit(generative_params: dict, design: np.ndarray,
                           param_names: list[str], subj_idx: np.ndarray,
                           jobs: list[tuple[str, float]],
                           n_simulations: int, alpha: float,
                           rng: np.random.Generator) -> list[float]:
    """Empirical power for a whole (parameter × multiplier) grid at once.

    The reference refits statsmodels MixedLM once per simulation
    (:2450-2469, 'drives runtime!').  Every job shares the same design
    matrix — only the generative coefficient vector differs — so ALL
    jobs × simulations stack into ONE batched REML solve on device
    (n_jobs · n_simulations responses), instead of one device dispatch
    and one host round trip per grid cell.

    Simulations are drawn in job order from the shared ``rng``, so the
    per-job powers are bit-identical to looping `jobs` over the
    single-job path.
    """
    residual_std = generative_params["residual_std"]
    re_std = generative_params["re_std"]
    n_subjects = int(subj_idx.max()) + 1
    n_obs = design.shape[0]
    y_blocks, cols = [], []
    for target_parameter, effect_multiplier in jobs:
        fixed = generative_params["fixed_effects"].copy()
        if target_parameter not in fixed:
            raise KeyError(
                f"[Power] '{target_parameter}' not found in fitted "
                f"parameters.\nAvailable: {list(fixed.keys())}")
        fixed[target_parameter] = (fixed[target_parameter]
                                   * effect_multiplier)
        coef = np.array([fixed.get(name, 0.0) for name in param_names])
        mu = design @ coef
        re = rng.normal(0.0, re_std, size=(n_simulations, n_subjects))
        eps = rng.normal(0.0, residual_std, size=(n_simulations, n_obs))
        y_blocks.append(mu[None, :] + re[:, subj_idx] + eps)
        cols.append(param_names.index(target_parameter))

    powers: list[float] = []
    nan_frac = 0.0
    # bound each device batch at ~8M response elements (HBM + upload)
    per_chunk = max(1, 8_000_000 // (n_simulations * max(n_obs, 1)))
    for start in range(0, len(jobs), per_chunk):
        chunk = y_blocks[start:start + per_chunk]
        out = batched_lme_pvalues(design, np.concatenate(chunk, axis=0),
                                  subj_idx)
        p_all = out["pvalues"].reshape(len(chunk), n_simulations, -1)
        for k, j in enumerate(cols[start:start + per_chunk]):
            p = p_all[k, :, j]
            powers.append(float(np.mean((~np.isnan(p)) & (p < alpha))))
            nan_frac += float(np.isnan(p).mean()) / len(jobs)
    if nan_frac > 0.01:
        warnings.warn(f"[Power] {nan_frac:.1%} of simulated p-values "
                      f"are NaN — the batched REML solve is failing on "
                      f"this design (counted as non-rejections).")
    return powers


def _simulate_and_fit(generative_params: dict, design: np.ndarray,
                      param_names: list[str], subj_idx: np.ndarray,
                      target_parameter: str, effect_multiplier: float,
                      n_simulations: int, alpha: float,
                      rng: np.random.Generator) -> float:
    """Empirical power for one parameter × multiplier (single-job
    wrapper over :func:`_simulate_jobs_and_fit`)."""
    return _simulate_jobs_and_fit(
        generative_params, design, param_names, subj_idx,
        [(target_parameter, effect_multiplier)], n_simulations, alpha,
        rng)[0]


def _derive_mde(power_curve: pd.DataFrame, target_parameter: str,
                fitted_coefficient: float,
                target_power: float) -> float | None:
    """Minimum detectable effect via linear interpolation (ref :2477)."""
    curve = power_curve.sort_values("effect_multiplier")
    above = curve[curve["power"] >= target_power]
    if above.empty:
        warnings.warn(
            f"[Power] Power never reaches {target_power:.0%} for "
            f"'{target_parameter}' within the simulated multiplier range.")
        return None
    first_above = above.iloc[0]
    idx = curve.index.get_loc(first_above.name)
    if idx == 0:
        return float(abs(fitted_coefficient
                         * first_above["effect_multiplier"]))
    row_lo, row_hi = curve.iloc[idx - 1], curve.iloc[idx]
    frac = ((target_power - row_lo["power"])
            / (row_hi["power"] - row_lo["power"] + 1e-12))
    mde_mult = (row_lo["effect_multiplier"]
                + frac * (row_hi["effect_multiplier"]
                          - row_lo["effect_multiplier"]))
    return float(abs(fitted_coefficient * mde_mult))


def run_power_analysis(configs: list[PowerConfig],
                       results_df: pd.DataFrame,
                       feature_output_data: Path,
                       statistics_output_data: Path,
                       fetch_level_definitions: Callable,
                       file_title: Callable | None = None,
                       save_full_power_curve: bool = False,
                       df_transform: Callable | None = None):
    """Simulation-based power analysis (batched REML refits on the device)."""
    file_title = file_title or filemgmt.file_title
    all_power_rows, all_mde_rows = [], []
    join_keys = ["Dependent_Variable", "Comparison_Level", "N_Segments",
                 "Parameter"]

    for cfg in configs:
        print(f"Power analysis | DV: {cfg.dependent_var} | "
              f"Level: {cfg.comp_lvl} | Segments: {cfg.n_segments}")
        rng = np.random.default_rng(cfg.random_seed)
        base_df = pd.read_csv(filemgmt.most_recent_file(
            feature_output_data, ".csv",
            [f"Combined Statistics {cfg.n_segments}seg"]))
        if df_transform is not None:
            base_df = df_transform(base_df)
        gen_params = _extract_lme_params(results_df, cfg.dependent_var,
                                         cfg.comp_lvl, cfg.n_segments)
        print(f"    generative: residual_std="
              f"{gen_params['residual_std']:.4g}, re_std="
              f"{gen_params['re_std']:.4g}, "
              f"|fixed| max={max(abs(v) for v in gen_params['fixed_effects'].values()):.4g}")
        level_def = fetch_level_definitions(cfg.n_segments > 1)[
            cfg.comp_lvl]
        sim_data = base_df.copy()
        if level_def.get("df_filter") is not None:
            sim_data = level_def["df_filter"](sim_data)
        cols = ([cfg.dependent_var, "Subject ID"]
                + list(level_def["condition_vars"])
                + level_def.get("explanatory_vars", []))
        sim_data = sim_data.dropna(
            subset=[c for c in cols if c in sim_data.columns])
        design, names = build_design_matrix(
            sim_data, level_def["condition_vars"],
            level_def.get("explanatory_vars", []),
            level_def.get("moderation_pairs"),
            level_def.get("reference_categories"))
        _, subj_idx = np.unique(sim_data["Subject ID"].to_numpy(),
                                return_inverse=True)

        target_params = []
        for param in (cfg.target_parameters
                      or [q for q in gen_params["fixed_effects"]
                          if q != "Intercept"]):
            if gen_params["fixed_effects"].get(param) is None:
                warnings.warn(f"  [Power] Parameter '{param}' not in "
                              f"fitted model — skipping.")
            else:
                target_params.append(param)
        jobs = [(param, multiplier) for param in target_params
                for multiplier in cfg.effect_multipliers]
        # one fused device solve for the whole grid (no round trip per
        # cell)
        job_powers = iter(_simulate_jobs_and_fit(
            gen_params, design, names, subj_idx, jobs,
            cfg.n_simulations, cfg.alpha, rng))
        for param in target_params:
            fitted_coef = gen_params["fixed_effects"].get(param)
            row_base = {"Dependent_Variable": cfg.dependent_var,
                        "Comparison_Level": cfg.comp_lvl,
                        "N_Segments": cfg.n_segments, "Parameter": param,
                        "Fitted_Coefficient": fitted_coef,
                        "N_Simulations": cfg.n_simulations,
                        "Alpha": cfg.alpha,
                        "Target_Power": cfg.target_power}
            param_rows = []
            for multiplier in cfg.effect_multipliers:
                power = next(job_powers)
                print(f"    multiplier={multiplier:.2f} | "
                      f"power={power:.3f}")
                all_power_rows.append({**row_base,
                                       "Effect_Multiplier": multiplier,
                                       "Absolute_Effect":
                                       abs(fitted_coef * multiplier),
                                       "Power": power})
                param_rows.append({"effect_multiplier": multiplier,
                                   "power": power})
            curve = pd.DataFrame(param_rows)
            mde = _derive_mde(curve, param, fitted_coef, cfg.target_power)
            observed = curve.loc[curve["effect_multiplier"] == 1.0,
                                 "power"].values
            power_at_obs = float(observed[0]) if len(observed) else np.nan
            interp = (f"INFORMATIVE: well-powered at observed effect "
                      f"(power={power_at_obs:.2f})"
                      if power_at_obs >= cfg.target_power else
                      f"UNINFORMATIVE: under-powered "
                      f"(power={power_at_obs:.2f}) — null does not rule "
                      f"out this effect")
            all_mde_rows.append({
                **row_base,
                "Power_at_Observed_Effect": power_at_obs,
                f"MDE_at_{cfg.target_power:.0%}_power": mde,
                "Interpretation": interp})

    mde_df = pd.DataFrame(all_mde_rows)
    mde_path = Path(statistics_output_data) / file_title(
        "Power Analysis MDE Summary", ".csv")
    mde_df.to_csv(mde_path, index=False)
    print(f"Saved MDE summary -> {mde_path} ({len(mde_df)} rows)")

    power_curve_df = pd.DataFrame(all_power_rows)
    if save_full_power_curve and len(power_curve_df):
        combined_df = power_curve_df.merge(
            mde_df[join_keys + ["Power_at_Observed_Effect",
                                f"MDE_at_{configs[0].target_power:.0%}"
                                f"_power", "Interpretation"]],
            on=join_keys, how="left")
        curve_path = Path(statistics_output_data) / file_title(
            "Power Analysis Full Curve", ".csv")
        combined_df.to_csv(curve_path, index=False)
    return mde_df, power_curve_df


def add_significance_markers(df: pd.DataFrame,
                             p_col_prefix: str = 'p_value'
                             ) -> pd.DataFrame:
    """Add star-marker columns for every p-value column with the prefix."""
    df = df.copy()

    def stars(p):
        if pd.isna(p):
            return ""
        return ("***" if p < 0.001 else "**" if p < 0.01
                else "*" if p < 0.05 else "")

    for col in [c for c in df.columns if c.startswith(p_col_prefix)]:
        df[f"{col}_sig"] = df[col].apply(stars)
    return df


# ═══════════════════════════════════════════════════════════════════════
#  summary tables & printers (reference statistical_modelling.py:1379-1783)
# ═══════════════════════════════════════════════════════════════════════
def _star(p) -> str:
    if pd.isna(p):
        return "ns"
    return ("***" if p < 0.001 else "**" if p < 0.01
            else "*" if p < 0.05 else "ns")


def _strip_sentinels(df: pd.DataFrame) -> pd.DataFrame:
    return df[~df["Parameter"].astype(str).str.startswith("__")]


def load_recent_results_frame(frame_dir) -> pd.DataFrame:
    """Newest 'All Time Resolutions Results' CSV (reference :1924-1927)."""
    return pd.read_csv(file_mgmt_most_recent(
        frame_dir, ["All Time Resolutions Results"]))


def load_recent_diagnostics_frame(frame_dir) -> pd.DataFrame:
    """Newest 'All Time Resolutions Diagnostics' CSV (ref :1929-1932)."""
    return pd.read_csv(file_mgmt_most_recent(
        frame_dir, ["All Time Resolutions Diagnostics"]))


def file_mgmt_most_recent(frame_dir, keywords):
    from mba_tpu.utils.file_management import most_recent_file
    return most_recent_file(Path(frame_dir), ".csv", keywords)


def create_summary_table(results_df: pd.DataFrame,
                         filter_conditions: dict,
                         index_cols: list,
                         value_cols: list | None = None,
                         output_file: str | None = None,
                         output_dir=None,
                         table_name: str = "Summary Table",
                         verbose: bool = True) -> pd.DataFrame:
    """Filtered pivot of the results frame, one column group per
    Model_Type, with significance stars (reference :1409-1496).

    filter_conditions values: str (exact), callable (predicate), or
    list/tuple (isin).
    """
    filtered = results_df.copy()
    for col, condition in filter_conditions.items():
        if isinstance(condition, str):
            filtered = filtered[filtered[col] == condition]
        elif callable(condition):
            try:
                filtered = filtered[filtered[col].apply(condition)]
            except Exception as exc:
                print(f"  [summary] filter error on {col!r}: {exc}")
        elif isinstance(condition, (list, tuple)):
            filtered = filtered[filtered[col].isin(condition)]
    if filtered.empty:
        if verbose:
            print(f"  [summary] no data for {table_name} "
                  f"(filters: {filter_conditions})")
        return pd.DataFrame()

    value_cols = value_cols or ["Coefficient", "p_value"]
    summary = filtered.pivot_table(index=index_cols,
                                   columns="Model_Type",
                                   values=value_cols, aggfunc="first")
    summary.columns = ["_".join(map(str, c)).strip()
                       for c in summary.columns.values]
    summary = summary.reset_index()
    for col in [c for c in summary.columns if c.startswith("p_value")]:
        summary[col.replace("p_value", "Sig")] = \
            summary[col].apply(_star)

    if verbose:
        print(f"\n{'=' * 100}\n{table_name.upper()}\n{'=' * 100}")
        print(summary.to_string(index=False))
    if output_file and output_dir is not None:
        path = Path(output_dir) / output_file
        summary.to_csv(path, index=False)
        if verbose:
            print(f"Saved -> {path}")
    return summary


def display_summary_statistics(results_df: pd.DataFrame,
                               printer=print) -> dict:
    """Significance-rate breakdown overall / by model / by level
    (reference :1498-1541).  Returns the counted figures."""
    df = _strip_sentinels(results_df)
    total = max(len(df), 1)
    counts = {thr: int((pd.to_numeric(df["p_value"], errors="coerce")
                        < thr).sum()) for thr in (0.001, 0.01, 0.05)}
    printer(f"\n{'=' * 100}\nSUMMARY STATISTICS\n{'=' * 100}")
    printer(f"Total effects tested:           {len(df)}")
    for thr, stars in ((0.001, '***'), (0.01, '**'), (0.05, '*')):
        printer(f"Significant at p < {thr} ({stars}): {counts[thr]} "
                f"({100 * counts[thr] / total:.1f}%)")
    by_model, by_level = {}, {}
    for model in df.get("Model_Type", pd.Series(dtype=str)).unique():
        sub = df[df["Model_Type"] == model]
        n_sig = int((pd.to_numeric(sub["p_value"],
                                   errors="coerce") < 0.05).sum())
        by_model[model] = (len(sub), n_sig)
        printer(f"  {model}: {len(sub)} effects, {n_sig} significant")
    for level in df.get("Comparison_Level",
                        pd.Series(dtype=str)).unique():
        sub = df[df["Comparison_Level"] == level]
        n_sig = int((pd.to_numeric(sub["p_value"],
                                   errors="coerce") < 0.05).sum())
        by_level[level] = (len(sub), n_sig)
        printer(f"  {level}: {len(sub)} effects, {n_sig} significant")
    return {"total": len(df), "counts": counts, "by_model": by_model,
            "by_level": by_level}


def display_significant_effects(results_df: pd.DataFrame,
                                significance_level: float = 0.05,
                                exclude_intercepts: bool = True,
                                printer=print) -> pd.DataFrame:
    """All significant effects sorted by p (reference :1543-1584)."""
    df = _strip_sentinels(results_df)
    sig = df[pd.to_numeric(df["p_value"], errors="coerce")
             < significance_level].copy()
    if exclude_intercepts:
        sig = sig[~sig["Parameter"].astype(str).str.contains(
            "Intercept", case=False, na=False)]
    if sig.empty:
        printer(f"No significant effects at p < {significance_level}")
        return sig
    sig = sig.sort_values("p_value")
    printer(f"\nALL SIGNIFICANT EFFECTS (p < {significance_level}"
            f"{', excluding intercepts' if exclude_intercepts else ''})"
            f": {len(sig)}")
    for _, row in sig.iterrows():
        printer(f"{str(row['Parameter']):<45s} | "
                f"{str(row.get('Model_Type', '')):<5s} | "
                f"beta={row['Coefficient']:>8.4f} | "
                f"p={row['p_value']:>8.4f} {_star(row['p_value'])}")
    return sig


def display_model_diagnostics(diagnostics_df: pd.DataFrame,
                              output_dir=None, printer=print) -> None:
    """Rounded diagnostics tables per model type with the legend
    (reference :1586-1693)."""
    if diagnostics_df is None or len(diagnostics_df) == 0:
        printer("No diagnostics data available")
        return
    disp = diagnostics_df.copy()
    for col in ("Shapiro_p", "Lag1_Autocorr", "Design_Effect",
                "SE_Inflation", "R_squared", "R_squared_adj",
                "R_squared_marginal", "R_squared_conditional",
                "AIC", "BIC", "LogLik"):
        if col in disp.columns:
            disp[col] = disp[col].apply(
                lambda x: f"{x:.4f}" if pd.notna(x) else "-")
    printer("[LEGEND] Shapiro_Violated=Yes: non-normal residuals | "
            "Lag1_Autocorr>0.3 moderate, >0.5 high | "
            "SE_Inflation>1.5 substantial | lower AIC/BIC better")
    for model_type in ("OLS", "LME"):
        sub = disp[disp.get("Model_Type") == model_type] \
            if "Model_Type" in disp.columns else pd.DataFrame()
        if len(sub):
            printer(f"\n{model_type} MODELS ({len(sub)})")
            printer(sub.to_string(index=False))
    if output_dir is not None:
        from mba_tpu.utils.file_management import file_title, assert_dir
        assert_dir(output_dir)
        diagnostics_df.to_csv(Path(output_dir) / file_title(
            "summary_model_diagnostics", ".csv"), index=False)


def generate_all_summary_tables(results_df: pd.DataFrame,
                                output_dir,
                                diagnostics_df: pd.DataFrame = None,
                                file_identifier: str = "",
                                generate_per_level_tables: bool = False,
                                generate_thematic_tables: bool = False,
                                verbose: bool = True) -> dict:
    """Master + per-level + thematic + significant-effects tables
    (reference :1695-1783).  Returns the written frames by name."""
    from mba_tpu.utils.file_management import file_title, assert_dir
    output_dir = Path(output_dir)
    assert_dir(output_dir)
    suffix = f"_{file_identifier}" if file_identifier else ""

    df = _strip_sentinels(results_df).copy()
    for p_col, sig_col in (("p_value_unadjusted",
                            "Significance_unadjusted"),
                           ("p_value_adjusted",
                            "Significance_adjusted")):
        if p_col in df.columns:
            df[sig_col] = df[p_col].apply(_star)
    if "Significance_adjusted" in df.columns:
        df["Significance"] = df["Significance_adjusted"]
    written = {}

    def save(frame, stem, label):
        if frame.empty:
            return
        path = output_dir / file_title(f"{stem}{suffix}", ".csv")
        frame.to_csv(path, index=False)
        written[label] = frame
        if verbose:
            print(f"TABLE: {label} -> {path} ({len(frame)} rows)")

    if generate_per_level_tables and "Comparison_Level" in df.columns:
        for level in sorted(df["Comparison_Level"].astype(str)
                            .unique()):
            stem = ("summary_level"
                    + level.lower().split("(")[0]
                    .replace("level ", "").strip().replace(" ", ""))
            save(df[df["Comparison_Level"] == level], stem, level)
    if generate_thematic_tables:
        params = df["Parameter"].astype(str)
        no_icpt = ~params.str.contains("Intercept", case=False)
        save(df[params.str.contains("Music", case=False) & no_icpt],
             "summary_music_effects", "MUSIC EFFECTS")
        save(df[params.str.contains("Force", case=False) & no_icpt],
             "summary_force_effects", "FORCE EFFECTS")
    if "Significance_adjusted" in df.columns:
        save(df[df["Significance_adjusted"].isin(["*", "**", "***"])],
             "summary_significant_effects", "SIGNIFICANT EFFECTS")
    save(df, "summary_all_results_master", "MASTER TABLE")

    if verbose:
        display_summary_statistics(df)
        display_significant_effects(df)
    if diagnostics_df is not None and len(diagnostics_df):
        display_model_diagnostics(diagnostics_df, output_dir,
                                  printer=(print if verbose
                                           else lambda *_: None))
        written["DIAGNOSTICS"] = diagnostics_df
    return written
