"""Random-intercept linear mixed model via profiled REML.

Replaces ``statsmodels.mixedlm(...).fit(reml=True)`` (reference
statistical_modelling.py:518-532) with a native solver built on the
random-intercept structure the reference exclusively uses:

    y = Xβ + Z b + ε,   b_g ~ N(0, σ_b²),   ε ~ N(0, σ_e²)

With λ = σ_b²/σ_e², every GLS quantity reduces to group sums via the
Woodbury identity (W_g⁻¹ = I − λ/(1+λ n_g) · J), so the profiled REML
criterion is a cheap scalar function of λ:

    L(λ) = (n−p)·ln(rᵀW⁻¹r) + Σ_g ln(1+λ n_g) + ln|XᵀW⁻¹X|

Two implementations share the math:
- :func:`fit_random_intercept_reml` — host (numpy/scipy Brent) single fit
  returning the statsmodels-shaped result (fe_params, bse, z-based
  pvalues, scale, cov_re, BLUPs, llf/aic/bic).
- :func:`batched_lme_pvalues` — the device path: thousands of simulated
  response vectors refit simultaneously (sufficient-statistics
  criterion + hierarchical parallel grid on ln λ).  This is what makes
  the reference's "very run-time extensive" power analysis
  (BASELINE.md) tractable.
"""
from __future__ import annotations

import functools

import numpy as np
from scipy import optimize, stats

import jax
import jax.numpy as jnp


# --------------------------------------------------------------------------
# shared sufficient statistics
# --------------------------------------------------------------------------
def _group_stats(X: np.ndarray, groups: np.ndarray):
    """Group indices + per-group design sums used by Woodbury reductions."""
    uniq, gidx = np.unique(groups, return_inverse=True)
    n_groups = len(uniq)
    counts = np.bincount(gidx, minlength=n_groups).astype(float)
    # Xg[g] = Σ_{i∈g} x_i   (n_groups, p)
    p = X.shape[1]
    Xg = np.zeros((n_groups, p))
    np.add.at(Xg, gidx, X)
    return uniq, gidx, counts, Xg


def _profiled_quantities(lam, X, y, gidx, counts, Xg, yg):
    """GLS β̂, residual quadratic form, and log-dets for one λ (numpy)."""
    w = lam / (1.0 + lam * counts)                       # (G,)
    xtx = X.T @ X - (Xg * w[:, None]).T @ Xg             # XᵀW⁻¹X
    xty = X.T @ y - (Xg * w[:, None]).T @ yg             # XᵀW⁻¹y
    beta = np.linalg.solve(xtx, xty)
    r = y - X @ beta
    rg = np.bincount(gidx, weights=r, minlength=len(counts))
    quad = r @ r - w @ rg ** 2                            # rᵀW⁻¹r
    logdet_w = np.sum(np.log1p(lam * counts))
    sign, logdet_xtx = np.linalg.slogdet(xtx)
    return beta, r, rg, quad, logdet_w, logdet_xtx, xtx, w


def fit_random_intercept_reml(X: np.ndarray, y: np.ndarray,
                              groups: np.ndarray,
                              param_names: list[str] | None = None) -> dict:
    """Profiled-REML random-intercept LME (statsmodels-shaped output)."""
    X = np.asarray(X, float)
    y = np.asarray(y, float)
    n, p = X.shape
    rank = np.linalg.matrix_rank(X)
    if rank < p:
        raise np.linalg.LinAlgError(
            f"Rank-deficient design matrix: rank={rank}, n_params={p}")

    uniq, gidx, counts, Xg = _group_stats(X, groups)
    yg = np.bincount(gidx, weights=y, minlength=len(uniq))

    def criterion(log_lam):
        lam = np.exp(log_lam)
        _, _, _, quad, logdet_w, logdet_xtx, _, _ = _profiled_quantities(
            lam, X, y, gidx, counts, Xg, yg)
        return ((n - p) * np.log(max(quad, 1e-300))
                + logdet_w + logdet_xtx)

    res = optimize.minimize_scalar(criterion, bounds=(-12.0, 8.0),
                                   method="bounded",
                                   options={"xatol": 1e-8})
    # boundary case: λ → 0 (no between-group variance)
    lam = float(np.exp(res.x))
    if criterion(-30.0) <= res.fun:
        lam = np.exp(-30.0)

    beta, r, rg, quad, logdet_w, logdet_xtx, xtx, w = _profiled_quantities(
        lam, X, y, gidx, counts, Xg, yg)
    scale = quad / (n - p)                                # σ_e² (REML)
    re_var = lam * scale                                  # σ_b²
    cov_beta = np.linalg.inv(xtx) * scale
    bse = np.sqrt(np.maximum(np.diag(cov_beta), 0.0))
    with np.errstate(divide='ignore', invalid='ignore'):
        zvals = np.where(bse > 0, beta / bse, np.nan)
    pvals = 2 * stats.norm.sf(np.abs(zvals))              # z-test (statsmodels)

    # BLUPs: b̂_g = λ/(1+λ n_g) · Σ_g r
    blups = (lam / (1.0 + lam * counts)) * rg

    llf = -0.5 * ((n - p) * np.log(2 * np.pi * scale)
                  + logdet_w + logdet_xtx
                  + (n - p))
    k = p + 2  # fixed effects + re variance + residual variance
    aic = -2 * llf + 2 * k
    bic = -2 * llf + k * np.log(n)

    names = (param_names if param_names is not None
             else [f"x{i}" for i in range(p)])
    return {
        "fe_params": dict(zip(names, beta)),
        "params": beta, "bse": bse, "zvalues": zvals, "pvalues": pvals,
        "scale": float(scale), "cov_re": float(re_var), "lam": lam,
        "resid": r, "random_effects": dict(zip(uniq.tolist(), blups)),
        "llf": float(llf), "aic": float(aic), "bic": float(bic),
        "converged": bool(res.success),
        "groups": uniq,
    }


# --------------------------------------------------------------------------
# batched device path (power simulations, bootstrap, LOSO fleets)
# --------------------------------------------------------------------------
_REML_BLOCK = 8192     # max responses per compiled REML executable


def _solve_psd_small(A, B):
    """Batched SPD solve + log-det for tiny static p, fully unrolled.

    A: (..., p, p) SPD; B: (..., p, m).  Returns (X, logdet) with
    X = A⁻¹B.  ``jnp.linalg.cholesky``/``cho_solve`` on a 600k-batch of
    6×6 matrices lowers to XLA's generic blocked linalg — measured
    ~100s of *compile* time at the power stage's shapes — while this
    unrolled Cholesky-Crout is ~p³/6 fused elementwise ops over the
    batch: sub-second compile, bandwidth-trivial run.  Non-PD inputs
    surface as NaNs (sqrt of a negative pivot), which callers map to
    +inf criteria / NaN p-values.
    """
    p = A.shape[-1]
    L = {}
    for j in range(p):
        for i in range(j, p):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[(i, k)] * L[(j, k)]
            L[(i, j)] = jnp.sqrt(s) if i == j else s / L[(j, j)]
    logdet = 2.0 * sum(jnp.log(L[(i, i)]) for i in range(p))
    ys = []
    for i in range(p):                     # forward: L y = B
        s = B[..., i, :]
        for k in range(i):
            s = s - L[(i, k)][..., None] * ys[k]
        ys.append(s / L[(i, i)][..., None])
    xs = [None] * p
    for i in reversed(range(p)):           # backward: Lᵀ x = y
        s = ys[i]
        for k in range(i + 1, p):
            s = s - L[(k, i)][..., None] * xs[k]
        xs[i] = s / L[(i, i)][..., None]
    return jnp.stack(xs, axis=-2), logdet


@functools.partial(jax.jit,
                   static_argnames=("n_groups", "n_grid", "n_levels"))
def _batched_reml_core(X, Y, gidx, counts, n_groups, n_grid=17,
                       n_levels=3):
    """Vectorised profiled REML for many response vectors at once.

    X: (n, p); Y: (S, n) simulated responses; returns (beta (S,p),
    bse (S,p), scale (S,), lam (S,)).

    Two design choices for a batched accelerator solve (their speed on
    the card is not measured yet):

    1. **Sufficient statistics via the OLS-residual split.**  Writing
       y = Xβ̂₀ + e₀ (β̂₀ the per-response OLS fit, X'e₀ = 0), every
       λ-dependent REML quantity reduces to {β̂₀, e₀'e₀, per-group sums
       of e₀} — all computed ONCE per response as matmuls — so the
       λ search does O(G·p² + p³) work per evaluation instead of O(n·p).
       The split is also exactly cancellation-free: r'r = e₀'e₀ +
       δ'X'Xδ with δ = β̂₀ − β(λ), both terms non-negative, unlike the
       y'y − 2β'X'y + β'X'Xβ expansion which loses ~log₁₀(y'y / r'r)
       digits in f32.

    2. **Hierarchical parallel λ-grid instead of a sequential search.**
       A golden-section scan is 2·n_iters dependent tiny-kernel rounds —
       latency-bound on an accelerator.  Here each level evaluates the criterion at
       ``n_grid`` points for ALL responses in one batched shot (the p×p
       Cholesky factors double as the |X'W⁻¹X| log-dets), then recenters
       on the per-response argmin: 3 levels of 17 points + a free
       parabolic-vertex refinement of the last bracket resolve ln λ to
       ≲1e-3 — beyond what β/SE can feel (tests pin rtol 2e-3 against
       the host Brent solver) — in 4 parallel rounds instead of ~120
       sequential ones.  Grid size matters twice: XLA's compile time
       grows superlinearly in the flat program.

    All matmuls run at ``Precision.HIGHEST``: the default matmul
    precision may round the inputs (TF32 on the GPU, ~1e-3 relative), which
    destroys X'X / X'y structure for study designs whose effects sit
    3-4 orders of magnitude below the column scales (DV ≈ 0.9 coherence
    vs category effects ≈ 1e-3, force 20-60 %MVC) — measured symptom:
    every simulated p-value ≈ 1 and power 0.000 at every multiplier
    while the identical solve on CPU (true f32) behaves.
    """
    prec = jax.lax.Precision.HIGHEST
    n, p = X.shape
    S = Y.shape[0]
    xtx_full = jnp.matmul(X.T, X, precision=prec)          # (p, p)
    Xg = jax.ops.segment_sum(X, gidx, num_segments=n_groups)  # (G, p)
    XgXg = (Xg[:, :, None] * Xg[:, None, :]).reshape(n_groups, p * p)

    # per-response sufficient statistics — one matmul pass over the data
    xty = jnp.matmul(X.T, Y.T, precision=prec)             # (p, S)
    beta_ols = jnp.linalg.solve(xtx_full, xty)             # (p, S)
    E0 = Y - jnp.matmul(X, beta_ols, precision=prec).T     # (S, n)
    ee = jnp.einsum('sn,sn->s', E0, E0, precision=prec)    # (S,)
    e0g = jax.ops.segment_sum(E0.T, gidx,
                              num_segments=n_groups)       # (G, S)
    yg = jnp.matmul(Xg, beta_ols, precision=prec) + e0g    # (G, S)
    beta_ols_s = beta_ols.T                                # (S, p)
    yg_s, e0g_s = yg.T, e0g.T                              # (S, G)

    def eval_grid(log_lams):
        """Criterion + fit quantities at (S, L) ln-λ points at once."""
        lam = jnp.exp(log_lams)                            # (S, L)
        a = lam[:, :, None] * counts                       # (S, L, G)
        w = lam[:, :, None] / (1.0 + a)                    # (S, L, G)
        xtx = (xtx_full
               - jnp.matmul(w, XgXg,
                            precision=prec).reshape(*w.shape[:2], p, p))
        xty_l = (xty.T[:, None, :]
                 - jnp.matmul(w * yg_s[:, None, :], Xg, precision=prec))
        beta, ldx = _solve_psd_small(xtx, xty_l[..., None])
        beta = beta[..., 0]                                # (S, L, p)
        delta = beta_ols_s[:, None, :] - beta
        rr = ee[:, None] + jnp.einsum('slp,pq,slq->sl', delta,
                                      xtx_full, delta, precision=prec)
        rg = e0g_s[:, None, :] + jnp.matmul(delta, Xg.T,
                                            precision=prec)  # (S, L, G)
        quad = rr - jnp.sum(w * rg * rg, axis=-1)
        ldw = jnp.sum(jnp.log1p(a), axis=-1)
        crit = ((n - p) * jnp.log(jnp.maximum(quad, 1e-30)) + ldw + ldx)
        crit = jnp.where(jnp.isnan(crit), jnp.inf, crit)
        return crit, xtx, beta, quad

    # Hierarchical grid as a lax.scan over levels: ONE instance of the
    # eval_grid body in the compiled program regardless of n_levels.
    # A flat unroll triples the program and pushes XLA into a
    # pathological regime (minutes of compile; deserialized cache
    # entries that wedge on execution) — the rolled form compiles in
    # seconds and round-trips the persistent cache safely.
    lo, hi = jnp.float32(-12.0), jnp.float32(8.0)
    offs = jnp.linspace(-1.0, 1.0, n_grid)                 # unit grid

    def level(carry, _):
        center, h, bval, seen_first = carry
        lls = center[:, None] + h * offs[None, :]
        crit, _, _, _ = eval_grid(lls)
        # ln λ = −12 is column 0 of the first level's grid exactly
        bval = jnp.where(seen_first, bval, crit[:, 0])
        idx = jnp.argmin(crit, axis=1)
        c = jnp.take_along_axis(lls, idx[:, None], 1)[:, 0]
        best = jnp.take_along_axis(crit, idx[:, None], 1)[:, 0]
        # free sub-grid refinement: parabola through the best point
        # and its two neighbours (already evaluated) puts the vertex
        # within O(spacing²) of the true minimum at no extra round
        spacing = 2.0 * h / (n_grid - 1)
        f_lo = jnp.take_along_axis(
            crit, jnp.maximum(idx - 1, 0)[:, None], 1)[:, 0]
        f_hi = jnp.take_along_axis(
            crit, jnp.minimum(idx + 1, n_grid - 1)[:, None], 1)[:, 0]
        denom = f_lo - 2.0 * best + f_hi
        vertex = 0.5 * spacing * (f_lo - f_hi) / jnp.where(
            denom > 0, denom, 1.0)
        vertex = jnp.where((denom > 0) & jnp.isfinite(vertex),
                           jnp.clip(vertex, -spacing, spacing), 0.0)
        return (c + vertex, spacing, bval,
                jnp.asarray(True)), best

    init = (jnp.full((S,), 0.5 * (lo + hi)), 0.5 * (hi - lo),
            jnp.zeros((S,)), jnp.asarray(False))
    (center, _, crit_boundary, _), bests = jax.lax.scan(
        level, init, None, length=n_levels)
    best = bests[-1]

    # boundary: λ→0 if the criterion prefers it
    log_lam = jnp.where(crit_boundary <= best, jnp.float32(-25.0),
                        center)
    _, xtx0, beta, quad = eval_grid(log_lam[:, None])
    scale = quad[:, 0] / (n - p)
    inv, _ = _solve_psd_small(
        xtx0[:, 0], jnp.broadcast_to(jnp.eye(p), (S, p, p)))
    bse = jnp.sqrt(jnp.maximum(
        jnp.diagonal(inv, axis1=-2, axis2=-1) * scale[:, None], 0.0))
    return beta[:, 0], bse, scale, jnp.exp(log_lam)


@functools.partial(jax.jit, static_argnames=("n_groups", "n_iters"))
def _batched_reml_weighted(Xb, Yb, Wb, gidx, n_groups, n_iters=60):
    """Vectorised profiled REML with per-batch designs and 0/1 row weights.

    Xb: (B, n, p); Yb: (B, n); Wb: (B, n) row weights (0 = absent row —
    exact row removal under the REML algebra).  Used for clustered
    bootstrap where every resample has its own padded design.  Returns
    beta (B, p).

    Matmuls at ``Precision.HIGHEST`` for the same reason as
    ``_batched_reml_core`` — default-precision (reduced-mantissa) matmul inputs destroy
    small effects against large column scales.
    """
    prec = jax.lax.Precision.HIGHEST

    def one(X, y, w):
        n_eff = jnp.sum(w)
        p = X.shape[1]
        Xw = X * w[:, None]
        counts = jax.ops.segment_sum(w, gidx, num_segments=n_groups)
        Xg = jax.ops.segment_sum(Xw, gidx, num_segments=n_groups)
        yg = jax.ops.segment_sum(y * w, gidx, num_segments=n_groups)
        xtx_full = jnp.matmul(Xw.T, X, precision=prec)
        xty_full = jnp.matmul(Xw.T, y, precision=prec)

        def quantities(lam):
            wg = lam / (1.0 + lam * counts)
            xtx = xtx_full - jnp.matmul((Xg * wg[:, None]).T, Xg,
                                        precision=prec)
            xty = xty_full - jnp.matmul((Xg * wg[:, None]).T, yg,
                                        precision=prec)
            beta = jnp.linalg.solve(xtx, xty)
            r = y - jnp.matmul(X, beta, precision=prec)
            rg = jax.ops.segment_sum(r * w, gidx, num_segments=n_groups)
            quad = (jnp.vdot(w * r, r, precision=prec)
                    - jnp.vdot(wg, rg ** 2, precision=prec))
            logdet_w = jnp.sum(jnp.log1p(lam * counts))
            _, logdet_xtx = jnp.linalg.slogdet(xtx)
            return beta, quad, logdet_w, logdet_xtx

        def criterion(log_lam):
            lam = jnp.exp(log_lam)
            _, quad, ldw, ldx = quantities(lam)
            return ((n_eff - p) * jnp.log(jnp.maximum(quad, 1e-30))
                    + ldw + ldx)

        gr = 0.6180339887498949
        lo, hi = jnp.float32(-12.0), jnp.float32(8.0)

        def gs_step(state, _):
            lo, hi = state
            c = hi - gr * (hi - lo)
            d = lo + gr * (hi - lo)
            lo = jnp.where(criterion(c) < criterion(d), lo, c)
            hi = jnp.where(criterion(c) < criterion(d), d, hi)
            return (lo, hi), None

        (lo, hi), _ = jax.lax.scan(gs_step, (lo, hi), None,
                                   length=n_iters)
        log_lam = 0.5 * (lo + hi)
        log_lam = jnp.where(criterion(jnp.float32(-12.0))
                            <= criterion(log_lam),
                            jnp.float32(-25.0), log_lam)
        beta, _, _, _ = quantities(jnp.exp(log_lam))
        return beta

    return jax.vmap(one)(Xb, Yb, Wb)


def batched_lme_pvalues(X: np.ndarray, Y: np.ndarray,
                        groups: np.ndarray) -> dict:
    """Fit S random-intercept REML models at once on device.

    X: (n, p) fixed design; Y: (S, n) responses (e.g. power simulations);
    returns dict with beta (S,p), bse (S,p), pvalues (S,p) (z-test),
    scale (S,), lam (S,).
    """
    uniq, gidx = np.unique(groups, return_inverse=True)
    counts = np.bincount(gidx, minlength=len(uniq)).astype(np.float32)
    # column equilibration: real designs mix scales (intercept 1,
    # dummies 0/1, force 20-60, trial id 0-30) — max-abs scaling drops
    # cond(X'X) by ~4 orders so the f32 device solve keeps the 2-3
    # digits the z-test needs.  Exact: beta/bse rescale covariantly,
    # λ and the residual scale are invariant (the REML criterion only
    # shifts by a λ-independent constant).
    col_scale = np.max(np.abs(X), axis=0)
    col_scale[col_scale == 0] = 1.0
    Xd = jnp.asarray(X / col_scale, jnp.float32)
    gd = jnp.asarray(gidx, jnp.int32)
    cd = jnp.asarray(counts)
    # XLA's compile time for the grid program grows superlinearly in
    # the response batch (measured: 12s at S=8192 but ~340s at
    # S=17500), so bound every compiled shape: blocks of
    # ≤ _REML_BLOCK responses, the tail zero-padded up to a power of
    # two — a handful of cacheable executables per design instead of
    # one unbounded compile per sweep size.  Padded rows are sliced
    # off; the solve is row-independent.
    S = Y.shape[0]
    outs = []
    start = 0
    while start < S:
        take = min(_REML_BLOCK, S - start)
        pad = max(1 << (take - 1).bit_length(), 64)
        block = np.zeros((pad, Y.shape[1]), np.float32)
        block[:take] = Y[start:start + take]
        outs.append(tuple(
            np.asarray(o)[:take] for o in _batched_reml_core(
                Xd, jnp.asarray(block), gd, cd, n_groups=len(uniq))))
        start += take
    beta, bse, scale, lam = (np.concatenate(parts, axis=0)
                             for parts in zip(*outs))
    beta = beta.astype(np.float64) / col_scale
    bse = bse.astype(np.float64) / col_scale
    with np.errstate(divide='ignore', invalid='ignore'):
        z = np.where(bse > 0, beta / bse, np.nan)
    pvalues = 2 * stats.norm.sf(np.abs(z))
    return {"beta": beta, "bse": bse, "pvalues": pvalues,
            "scale": np.asarray(scale), "lam": np.asarray(lam)}
