"""Baron–Kenny mediation with clustered bootstrap (batched on the device).

Parity target: reference ``src/statistics_RQ_A_mediation_analysis_workflow
.py`` — a/b/c/c′ MixedLM paths per (contrast, mediator, outcome)
(:142-313), mediation-type taxonomy (:106-139), subject-block clustered
bootstrap of the indirect effect a·b with percentile CI + bootstrap p
(:437-540), per-DV BH-FDR (:315-366), omnibus join (:369-434), and the
report-ready table (:543-645).

Device redesign: the reference refits two statsmodels MixedLMs per bootstrap
resample sequentially (``n_bootstrap = 300  # todo: drives runtime!``).
Here every resample is a row-weighted padded design and ALL resamples are
one `` _batched_reml_weighted`` call — the a-path and c′-path fleets each
solve in a single device program.
"""
from __future__ import annotations

import re

import numpy as np
import pandas as pd

import jax.numpy as jnp

from mba_tpu.models.lme import (fit_random_intercept_reml,
                                _batched_reml_weighted)
from mba_tpu.models.fdr import benjamini_hochberg

GROUP_VAR = "Subject ID"

LEVEL1_X_VAR = "Category or Silence"
LEVEL1_CONTRASTS: list[tuple[str, str]] = [
    ("Happy", "Silence"), ("Groovy", "Silence"),
    ("Sad", "Silence"), ("Classic", "Silence"),
]
MEDIATOR_CANDIDATES: list[str] = [
    "Emotional_State", "GSR", "Median_HRV", "Median_Heart_Rate",
]
RQA_CMC_DVS: list[str] = [
    "CMC_Flexor_max_beta", "CMC_Flexor_mean_beta",
    "CMC_Flexor_max_gamma", "CMC_Flexor_mean_gamma",
    "CMC_Extensor_max_beta", "CMC_Extensor_mean_beta",
    "CMC_Extensor_max_gamma", "CMC_Extensor_mean_gamma",
]
CMC_OUTCOMES = RQA_CMC_DVS.copy()


def fetch_mediation_hypotheses() -> list[dict]:
    """Level-1 mediation configs (reference :91-105)."""
    return [{
        "name": f"L1 Mediation: {m} mediates Category-or-Silence -> CMC",
        "x_var": LEVEL1_X_VAR, "x_contrasts": LEVEL1_CONTRASTS,
        "m_var": m, "y_vars": CMC_OUTCOMES,
        "description": (f"Level 1 only: does {m} explain "
                        f"category-vs-silence effects on CMC?"),
    } for m in MEDIATOR_CANDIDATES]


def _classify_mediation_type(p_c, p_cprime, coef_c, coef_cprime,
                             indirect_significant, alpha=0.05) -> str:
    """Baron & Kenny + modern taxonomy (reference :106-139)."""
    vals = [p_c, p_cprime, coef_c, coef_cprime]
    if any(v is None or (isinstance(v, float) and np.isnan(v))
           for v in vals):
        return "unclassifiable"
    if not indirect_significant:
        return "no_mediation"
    if np.sign(coef_c) != np.sign(coef_cprime) and abs(coef_c) > 1e-10:
        return "competitive"
    c_sig, cprime_sig = p_c < alpha, p_cprime < alpha
    if c_sig and not cprime_sig:
        return "full"
    if c_sig and cprime_sig:
        return "partial"
    return "indirect_only"


def _fit_path(X: np.ndarray, y: np.ndarray, groups: np.ndarray,
              names: list[str]) -> dict:
    res = fit_random_intercept_reml(X, y, groups, names)
    res["converged"] = bool(res["converged"])
    return res


def fit_mediation_model(data: pd.DataFrame, x_var: str,
                        x_contrast: tuple[str, str], m_var: str,
                        y_var: str, group_var: str = GROUP_VAR,
                        min_obs: int = 12,
                        min_subjects: int = 6) -> dict:
    """a/b/c/c′ paths for one configuration (reference :142-313)."""
    base = {"x_var": x_var,
            "x_contrast": f"{x_contrast[0]} vs {x_contrast[1]}",
            "mediator": m_var, "outcome": y_var}
    missing = sorted(c for c in {x_var, m_var, y_var, group_var}
                     if c not in data.columns)
    if missing:
        return {**base, "status": "skipped_missing_columns",
                "missing_columns": ", ".join(missing)}

    level_a, level_b = x_contrast
    df = data.loc[data[x_var].isin([level_a, level_b]),
                  [x_var, m_var, y_var, group_var]].copy()
    df[m_var] = pd.to_numeric(df[m_var], errors="coerce")
    df[y_var] = pd.to_numeric(df[y_var], errors="coerce")
    df = df.dropna()
    if df.empty or set(df[x_var].unique()) != {level_a, level_b}:
        return {**base, "status": "insufficient_data",
                "n_obs": int(len(df)),
                "n_subjects": int(df[group_var].nunique()) if len(df)
                else 0,
                "reason": "contrast levels missing after filtering"}

    model_df = pd.DataFrame({
        "x": (df[x_var] == level_a).astype(int).to_numpy(),
        "m": df[m_var].to_numpy(),
        "y": df[y_var].to_numpy(),
        "group": df[group_var].to_numpy()})
    n_obs, n_subjects = len(model_df), model_df["group"].nunique()
    if n_obs < min_obs or n_subjects < min_subjects:
        return {**base, "status": "insufficient_data", "n_obs": n_obs,
                "n_subjects": n_subjects,
                "reason": f"needs at least {min_obs} obs and "
                          f"{min_subjects} subjects"}

    x = model_df["x"].to_numpy(float)
    m = model_df["m"].to_numpy(float)
    y = model_df["y"].to_numpy(float)
    g = model_df["group"].to_numpy()
    ones = np.ones_like(x)
    try:
        res_a = _fit_path(np.stack([ones, x], 1), m, g,
                          ["Intercept", "x"])
        res_c = _fit_path(np.stack([ones, x], 1), y, g,
                          ["Intercept", "x"])
        res_cp = _fit_path(np.stack([ones, x, m], 1), y, g,
                           ["Intercept", "x", "m"])
    except Exception as exc:
        return {**base, "status": "error", "n_obs": n_obs,
                "n_subjects": n_subjects, "error": str(exc)}

    coef_a, se_a, p_a = (res_a["params"][1], res_a["bse"][1],
                         res_a["pvalues"][1])
    coef_c, se_c, p_c = (res_c["params"][1], res_c["bse"][1],
                         res_c["pvalues"][1])
    coef_cprime, se_cprime, p_cprime = (res_cp["params"][1],
                                        res_cp["bse"][1],
                                        res_cp["pvalues"][1])
    coef_b, se_b, p_b = (res_cp["params"][2], res_cp["bse"][2],
                         res_cp["pvalues"][2])
    converged = {"a": res_a["converged"], "c": res_c["converged"],
                 "cprime": res_cp["converged"]}
    fit_quality = ("strict_ok" if all(converged.values())
                   else "not_fittable")
    indirect = float(coef_a * coef_b)
    return {
        **base,
        "status": "fitted" if fit_quality != "not_fittable"
        else "non_converged",
        "n_obs": n_obs, "n_subjects": n_subjects,
        "fit_quality": fit_quality,
        "path_a_converged": converged["a"],
        "path_c_converged": converged["c"],
        "path_cprime_converged": converged["cprime"],
        "fit_warning_count": 0, "fit_warning_signature": "",
        "coef_a": float(coef_a), "se_a": float(se_a), "p_a": float(p_a),
        "coef_b": float(coef_b), "se_b": float(se_b), "p_b": float(p_b),
        "coef_c": float(coef_c), "se_c": float(se_c), "p_c": float(p_c),
        "coef_cprime": float(coef_cprime),
        "se_cprime": float(se_cprime), "p_cprime": float(p_cprime),
        "indirect_effect": indirect,
        "mediation_prop": (indirect / coef_c if coef_c != 0 else np.nan),
        "model_df": model_df,
    }


def bootstrap_indirect_effect(fit_result: dict, n_bootstrap: int = 2000,
                              ci: float = 0.95,
                              random_state: int = 42) -> dict:
    """Clustered-bootstrap percentile CI for a·b (reference :453-540).

    All resamples run as ONE batched weighted-REML solve per path.
    """
    if fit_result.get("status") != "fitted":
        return {"bootstrap_status": fit_result.get("status", "not_fitted"),
                "ci_lower": np.nan, "ci_upper": np.nan,
                "significant": False, "n_bootstrap": 0}
    model_df = fit_result["model_df"]
    if model_df.empty:
        return {"bootstrap_status": "bootstrap_failed",
                "ci_lower": np.nan, "ci_upper": np.nan,
                "significant": False, "n_bootstrap": 0}

    rng = np.random.default_rng(random_state)
    subjects, subj_codes = np.unique(model_df["group"].to_numpy(),
                                     return_inverse=True)
    n_subj = len(subjects)
    # pad per-subject blocks to the max block size → fixed-shape gather
    block_rows = [np.flatnonzero(subj_codes == s) for s in range(n_subj)]
    m_max = max(len(b) for b in block_rows)
    pad_rows = np.zeros((n_subj, m_max), np.int32)
    pad_w = np.zeros((n_subj, m_max), np.float32)
    for s, rows in enumerate(block_rows):
        pad_rows[s, :len(rows)] = rows
        pad_w[s, :len(rows)] = 1.0

    x = model_df["x"].to_numpy(np.float32)
    m = model_df["m"].to_numpy(np.float32)
    y = model_df["y"].to_numpy(np.float32)

    draws = rng.integers(0, n_subj, size=(n_bootstrap, n_subj))
    rows_b = pad_rows[draws].reshape(n_bootstrap, -1)      # (B, S·m_max)
    w_b = pad_w[draws].reshape(n_bootstrap, -1)
    x_b, m_b, y_b = x[rows_b], m[rows_b], y[rows_b]
    ones = np.ones_like(x_b)
    # each resampled block is its own group: group = slot index // m_max
    gidx = np.repeat(np.arange(n_subj, dtype=np.int32), m_max)

    Xa = np.stack([ones, x_b], axis=2)                     # (B, n, 2)
    beta_a = np.asarray(_batched_reml_weighted(
        jnp.asarray(Xa), jnp.asarray(m_b), jnp.asarray(w_b),
        jnp.asarray(gidx), n_groups=n_subj))
    Xcp = np.stack([ones, x_b, m_b], axis=2)               # (B, n, 3)
    beta_cp = np.asarray(_batched_reml_weighted(
        jnp.asarray(Xcp), jnp.asarray(y_b), jnp.asarray(w_b),
        jnp.asarray(gidx), n_groups=n_subj))

    indirect = beta_a[:, 1] * beta_cp[:, 2]
    finite = np.isfinite(indirect)
    indirect = indirect[finite]
    n_success = int(finite.sum())
    if n_success < 50:
        return {"bootstrap_status": "bootstrap_failed",
                "ci_lower": np.nan, "ci_upper": np.nan,
                "significant": False, "n_bootstrap": n_success,
                "bootstrap_attempted": n_bootstrap,
                "bootstrap_success": n_success,
                "bootstrap_non_converged": n_bootstrap - n_success,
                "bootstrap_exceptions": 0,
                "bootstrap_success_rate": n_success / n_bootstrap}

    alpha = 1.0 - ci
    ci_lower = float(np.percentile(indirect, alpha / 2 * 100))
    ci_upper = float(np.percentile(indirect, (1 - alpha / 2) * 100))
    n_total = len(indirect)
    n_below = int((indirect < 0).sum())
    n_above = int((indirect > 0).sum())
    p_boot = max(2 * min(n_below, n_above) / n_total, 1 / n_total)
    return {
        "bootstrap_status": "computed",
        "ci_lower": ci_lower, "ci_upper": ci_upper,
        "significant": not (ci_lower <= 0 <= ci_upper),
        "n_bootstrap": n_total, "bootstrap_attempted": n_bootstrap,
        "bootstrap_success": n_success,
        "bootstrap_non_converged": n_bootstrap - n_success,
        "bootstrap_exceptions": 0,
        "bootstrap_success_rate": n_success / n_bootstrap,
        "bootstrap_median_indirect": float(np.median(indirect)),
        "bootstrap_p": float(p_boot),
        "ci_width": float(ci_upper - ci_lower),
    }


def apply_fdr_and_enrich(results_frame: pd.DataFrame,
                         alpha: float = 0.05) -> pd.DataFrame:
    """BH-FDR per outcome family + mediation-type classification
    (reference :315-366)."""
    df = results_frame.copy()
    df["ci_width"] = (pd.to_numeric(df["ci_upper"], errors="coerce")
                      - pd.to_numeric(df["ci_lower"], errors="coerce"))

    def classify(r):
        try:
            return _classify_mediation_type(
                p_c=r.get("p_c"), p_cprime=r.get("p_cprime"),
                coef_c=r.get("coef_c"), coef_cprime=r.get("coef_cprime"),
                indirect_significant=bool(r.get("significant", False)),
                alpha=alpha)
        except Exception:
            return "unclassifiable"

    df["mediation_type"] = df.apply(classify, axis=1)
    df["p_indirect_fdr"] = np.nan
    df["significant_fdr"] = False
    computed = df["bootstrap_status"] == "computed"
    for _, grp_idx in df[computed].groupby("outcome").groups.items():
        pvals = pd.to_numeric(df.loc[grp_idx, "bootstrap_p"],
                              errors="coerce")
        valid = pvals.notna()
        if valid.sum() < 2:
            continue
        reject, p_fdr = benjamini_hochberg(pvals[valid], alpha=alpha)
        idx = pvals.index[valid.values]
        df.loc[idx, "p_indirect_fdr"] = p_fdr
        df.loc[idx, "significant_fdr"] = p_fdr < alpha
    return df


def join_omnibus_direct_effects(results_frame: pd.DataFrame,
                                omnibus_frame: pd.DataFrame,
                                n_segments: int = 1,
                                alpha: float = 0.05) -> pd.DataFrame:
    """Attach omnibus LME X→Y effects per (contrast, outcome)
    (reference :369-434)."""
    omni = omnibus_frame[(omnibus_frame["Model_Type"] == "LME")
                         & (omnibus_frame["N. Segments"]
                            == n_segments)].copy()

    def to_contrast(param):
        match = re.search(r"\[T\.(.+?)\]", str(param))
        return f"{match.group(1)} vs Silence" if match else None

    omni["_contrast"] = omni["Parameter"].apply(to_contrast)
    omni = omni.dropna(subset=["_contrast"])
    lookup = (omni.set_index(["Dependent_Variable", "_contrast"])[[
        "Coefficient", "p_value_adjusted", "Cohen_d"]]
        .rename(columns={"Coefficient": "omnibus_coef_c",
                         "p_value_adjusted": "omnibus_p_c",
                         "Cohen_d": "omnibus_cohen_d"})
        .reset_index()
        .rename(columns={"Dependent_Variable": "outcome",
                         "_contrast": "x_contrast"})
        .drop_duplicates(subset=["outcome", "x_contrast"], keep="first"))
    df = results_frame.copy().merge(lookup, on=["outcome", "x_contrast"],
                                    how="left")
    df["omnibus_sig"] = pd.to_numeric(df["omnibus_p_c"],
                                      errors="coerce") < alpha
    return df


def extract_report_ready_mediation_table(
        results_frame: pd.DataFrame, include_relaxed_ok: bool = False,
        min_bootstrap_success_rate: float = 0.70,
        min_bootstrap_samples: int = 100) -> pd.DataFrame:
    """Report-ready filtered + renamed table (reference :543-645)."""
    if results_frame is None or results_frame.empty:
        return pd.DataFrame()
    # if every config early-exited (skipped/insufficient/error), the
    # fitted-only columns never materialized — nothing to report
    for col in ("status", "bootstrap_status", "fit_quality",
                "bootstrap_success_rate", "n_bootstrap"):
        if col not in results_frame.columns:
            return pd.DataFrame()
    allowed = (["strict_ok", "relaxed_ok"] if include_relaxed_ok
               else ["strict_ok"])
    table = results_frame[
        (results_frame["status"] == "fitted")
        & (results_frame["bootstrap_status"] == "computed")
        & (results_frame["fit_quality"].isin(allowed))
        & (pd.to_numeric(results_frame["bootstrap_success_rate"],
                         errors="coerce")
           >= min_bootstrap_success_rate)
        & (pd.to_numeric(results_frame["n_bootstrap"], errors="coerce")
           >= min_bootstrap_samples)].copy()
    if table.empty:
        return table
    table["Sign"] = np.where(
        pd.to_numeric(table["indirect_effect"], errors="coerce") >= 0,
        "+", "-")
    table["CI_Contains_Zero"] = (
        (pd.to_numeric(table["ci_lower"], errors="coerce") <= 0)
        & (pd.to_numeric(table["ci_upper"], errors="coerce") >= 0))
    rename = {
        "x_contrast": "Contrast", "mediator": "Mediator",
        "outcome": "Outcome", "n_obs": "N_Obs",
        "n_subjects": "N_Subjects", "coef_a": "Path_a_X_to_M",
        "coef_b": "Path_b_M_to_Y_given_X",
        "coef_c": "Path_c_Total_X_to_Y",
        "coef_cprime": "Path_cprime_Direct_X_to_Y_given_M",
        "indirect_effect": "Indirect_a_times_b",
        "ci_lower": "CI95_Lower", "ci_upper": "CI95_Upper",
        "significant": "Indirect_Significant",
        "fit_quality": "Fit_Quality",
        "fit_warning_count": "Fit_Warning_Count",
        "bootstrap_success": "Bootstrap_Success",
        "bootstrap_attempted": "Bootstrap_Attempted",
        "bootstrap_success_rate": "Bootstrap_Success_Rate",
        "se_a": "Path_a_SE", "p_a": "Path_a_p", "se_b": "Path_b_SE",
        "p_b": "Path_b_p", "se_cprime": "Path_cprime_SE",
        "p_cprime": "Path_cprime_p",
        "mediation_prop": "Proportion_Mediated",
        "mediation_type": "Mediation_Type",
        "p_indirect_fdr": "p_Indirect_FDR",
        "bootstrap_p": "p_Bootstrap",
        "bootstrap_median_indirect": "Bootstrap_Median_Indirect",
        "ci_width": "CI95_Width",
        "omnibus_coef_c": "Omnibus_Beta_X_to_Y",
        "omnibus_p_c": "Omnibus_p_X_to_Y",
        "omnibus_cohen_d": "Omnibus_Cohen_d",
        "omnibus_sig": "Omnibus_Significant",
        "significant_fdr": "Significant_FDR",
    }
    cols = [c for c in rename if c in table.columns] + \
        ["Sign", "CI_Contains_Zero"]
    table = table[cols].rename(columns=rename)
    return table.sort_values(["Contrast", "Mediator", "Outcome"]
                             ).reset_index(drop=True)
