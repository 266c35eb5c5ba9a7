"""Golden-fixture proof of the statistics tier (VERDICT.md round-1 item 1).

statsmodels/MNE cannot be installed in this environment, so numerical
equivalence is established three independent ways:

1. **Closed forms.** For balanced one-way random-intercept designs the REML
   variance components equal the ANOVA estimators (MSW, (MSB−MSW)/m) and
   the GLS β/SE have textbook closed forms — asserted exactly.
2. **Pinned direct-REML oracle.** An independent implementation of the
   published REML formulae (explicit V = σe²I + σb²ZZᵀ, slogdet, GLS via
   solve, Nelder-Mead over (log σb², log σe²)) was run once on a frozen
   unbalanced dataset; its outputs are hard-pinned below and the production
   Woodbury/profiled solver must reproduce every statistic (β, SE, z, p,
   σb², σe², ICC, REML llf) within GOLDEN_TOLERANCES.  The oracle code is
   kept here (``_direct_reml_oracle``) and re-run as a self-check.
3. **Exact randomisation test.** The cluster permutation engine enumerates
   all 2^n sign assignments (``exact=True``) and must agree EXACTLY with a
   slow, independent numpy+scipy oracle that implements the MNE semantics:
   cluster-forming t threshold from the t-distribution, clusters by sparse
   adjacency, cluster mass = sum of t, H0 = max mass per assignment,
   p = mean(H0 ≥ |mass|).

Reference targets: statistical_modelling.py:379-865 (smf.mixedlm REML +
Wald z), cbpa.py:985-1067 (spatio_temporal_cluster_1samp_test).
"""
import numpy as np
import pytest
import scipy.sparse
import scipy.sparse.csgraph
from scipy import optimize, stats

from mba_tpu.models.lme import (fit_random_intercept_reml,
                                batched_lme_pvalues)
from mba_tpu.ops.permutation import (cluster_permutation_1samp_test,
                                     combine_adjacency)

# measured-deviation contract per statistic (see VERDICT r1 item 1 "Done")
GOLDEN_TOLERANCES = {
    "beta": 1e-6, "bse": 1e-6, "z": 1e-5, "p": 1e-7,
    "sigma_b2": 1e-5, "sigma_e2": 1e-5, "icc": 1e-5, "llf": 1e-6,
    "cluster_p": 0.0,          # exact enumeration: must match exactly
    "batched_vs_host_beta": 5e-4, "batched_vs_host_bse": 5e-4,
}


# ===========================================================================
# 1. closed-form balanced designs
# ===========================================================================
class TestClosedFormBalanced:
    def _balanced(self, J=8, m=6, seed=3, sigma_b=0.9, sigma_e=1.3):
        rng = np.random.default_rng(seed)
        groups = np.repeat(np.arange(J), m)
        y = (2.0 + rng.normal(0, sigma_b, J)[groups]
             + rng.normal(0, sigma_e, J * m))
        return y, groups, J, m

    def test_intercept_only_equals_anova_reml(self):
        y, groups, J, m = self._balanced()
        X = np.ones((len(y), 1))
        fit = fit_random_intercept_reml(X, y, groups)

        gm = y.reshape(J, m).mean(axis=1)
        grand = y.mean()
        ssb = m * ((gm - grand) ** 2).sum()
        ssw = ((y.reshape(J, m) - gm[:, None]) ** 2).sum()
        msb = ssb / (J - 1)
        msw = ssw / (J * (m - 1))
        sigma_e2 = msw                       # ANOVA = REML when balanced
        sigma_b2 = max((msb - msw) / m, 0.0)

        assert fit["scale"] == pytest.approx(sigma_e2, rel=1e-6)
        assert fit["cov_re"] == pytest.approx(sigma_b2, rel=1e-5)
        # GLS intercept = grand mean; Var = MSB/(J·m)
        assert fit["params"][0] == pytest.approx(grand, rel=1e-9)
        assert fit["bse"][0] == pytest.approx(np.sqrt(msb / (J * m)),
                                              rel=1e-6)

    def test_within_centered_covariate_closed_form(self):
        y, groups, J, m = self._balanced(seed=4)
        rng = np.random.default_rng(5)
        x = rng.standard_normal((J, m))
        x -= x.mean(axis=1, keepdims=True)    # centered within group
        x = x.ravel()
        beta1 = 0.7
        y = y + beta1 * x
        X = np.column_stack([np.ones_like(x), x])
        fit = fit_random_intercept_reml(X, y, groups)

        # x ⊥ group space ⇒ W⁻¹x = x ⇒ β̂₁ = xᵀy/xᵀx, SE² = σe²/xᵀx
        b1 = (x @ y) / (x @ x)
        assert fit["params"][1] == pytest.approx(b1, rel=1e-8)
        assert fit["bse"][1] == pytest.approx(
            np.sqrt(fit["scale"] / (x @ x)), rel=1e-7)

    def test_zero_between_variance_boundary(self):
        """Equal group means (MSB = 0 < MSW) → σb² pinned at the λ→0
        boundary."""
        rng = np.random.default_rng(6)
        groups = np.repeat(np.arange(10), 8)
        y = rng.standard_normal(80)
        y -= y.reshape(10, 8).mean(axis=1).repeat(8)   # group means = 0
        fit = fit_random_intercept_reml(np.ones((80, 1)), y, groups)
        assert fit["cov_re"] < 1e-6 * fit["scale"]


# ===========================================================================
# 2. pinned direct-REML oracle (frozen unbalanced dataset)
# ===========================================================================
SIZES = [3, 8, 5, 4, 7, 6]
Y = np.array([
    0.213414, 3.004264, -1.049585, -0.940711, 1.61333, -0.881407,
    -2.377069, 0.54231, -0.226084, -3.023316, -0.377639, 2.650118,
    0.052135, 1.637152, -0.992376, 2.320308, 0.960609, -0.528319,
    -0.215872, 1.002966, 1.741322, 0.564879, 1.169295, -1.590538,
    -0.176336, -0.679129, -1.893588, 0.085272, 0.701772, -0.243256,
    0.155004, 2.058448, -1.079499])
X1 = np.array([
    -1.423825, 1.263728, -0.870662, -0.259173, -0.075343, -0.740885,
    -1.367793, 0.648893, 0.361058, -1.952863, 2.34741, 0.968497,
    -0.759387, 0.902198, -0.466953, -0.06069, 0.788844, -1.256668,
    0.575858, 1.398979, 1.322298, -0.299699, 0.902919, -1.621583,
    -0.158189, 0.449484, -1.343601, -0.081688, 1.72474, 2.618159,
    0.777361, 0.828633, -0.958988])
X2 = np.array([
    -1.209388, -1.412292, 0.541547, 0.751939, -0.65876, -1.228675,
    0.257558, 0.312903, -0.130812, 1.269983, -0.092962, -0.066151,
    -1.108214, 0.135957, 1.347078, 0.061144, 0.070915, 0.433655,
    0.277484, 0.530252, 0.536721, 0.61835, -0.795017, 0.300031,
    -1.602702, 0.266799, -1.261624, -0.071271, 0.47405, -0.414854,
    0.097717, -1.640418, -0.857259])

# oracle outputs, generated once by _direct_reml_oracle (kept for re-run)
PINNED = {
    "sigma_b2": 0.2673462261,
    "sigma_e2": 1.0009976018,
    "beta": np.array([0.04789015, 0.75070499, -0.47216393]),
    "bse": np.array([0.27964907, 0.15857197, 0.22929357]),
    "z": np.array([0.17125087, 4.7341596, -2.05921136]),
    "p": np.array([8.64026510e-01, 2.19964596e-06, 3.94739950e-02]),
    "icc": 0.2107837167,
    "llf": -49.8410484773,
}


def _fixture():
    groups = np.concatenate([[j] * s for j, s in enumerate(SIZES)])
    X = np.column_stack([np.ones(len(Y)), X1, X2])
    return X, Y, groups


def _direct_reml_oracle(X, y, groups):
    """Independent direct REML: explicit V, published formulae only."""
    n, p = X.shape
    G = groups.max() + 1
    Z = np.zeros((n, G))
    Z[np.arange(n), groups] = 1.0

    def neg_loglik(params):
        sb2, se2 = np.exp(params)
        V = se2 * np.eye(n) + sb2 * (Z @ Z.T)
        Vi = np.linalg.inv(V)
        XtVX = X.T @ Vi @ X
        beta = np.linalg.solve(XtVX, X.T @ Vi @ y)
        r = y - X @ beta
        _, ldV = np.linalg.slogdet(V)
        _, ldX = np.linalg.slogdet(XtVX)
        return 0.5 * (ldV + ldX + r @ Vi @ r + (n - p) * np.log(2 * np.pi))

    res = optimize.minimize(neg_loglik, [0.0, 0.0], method="Nelder-Mead",
                            options={"xatol": 1e-10, "fatol": 1e-12,
                                     "maxiter": 5000})
    sb2, se2 = np.exp(res.x)
    V = se2 * np.eye(n) + sb2 * (Z @ Z.T)
    Vi = np.linalg.inv(V)
    XtVX = X.T @ Vi @ X
    beta = np.linalg.solve(XtVX, X.T @ Vi @ y)
    bse = np.sqrt(np.diag(np.linalg.inv(XtVX)))
    return {"sigma_b2": sb2, "sigma_e2": se2, "beta": beta, "bse": bse,
            "llf": -res.fun}


class TestPinnedOracle:
    def test_oracle_reproduces_pinned(self):
        """Self-check: the committed numbers ARE what the oracle produces."""
        X, y, groups = _fixture()
        o = _direct_reml_oracle(X, y, groups)
        np.testing.assert_allclose(o["beta"], PINNED["beta"], atol=1e-6)
        np.testing.assert_allclose(o["sigma_b2"], PINNED["sigma_b2"],
                                   atol=1e-6)
        np.testing.assert_allclose(o["llf"], PINNED["llf"], atol=1e-6)

    def test_production_matches_pinned_table(self):
        X, y, groups = _fixture()
        fit = fit_random_intercept_reml(
            X, y, groups, param_names=["const", "x1", "x2"])
        tol = GOLDEN_TOLERANCES
        np.testing.assert_allclose(fit["params"], PINNED["beta"],
                                   atol=tol["beta"])
        np.testing.assert_allclose(fit["bse"], PINNED["bse"],
                                   atol=tol["bse"])
        np.testing.assert_allclose(fit["zvalues"], PINNED["z"],
                                   atol=tol["z"])
        np.testing.assert_allclose(fit["pvalues"], PINNED["p"],
                                   atol=tol["p"])
        assert fit["cov_re"] == pytest.approx(PINNED["sigma_b2"],
                                              abs=tol["sigma_b2"])
        assert fit["scale"] == pytest.approx(PINNED["sigma_e2"],
                                             abs=tol["sigma_e2"])
        icc = fit["cov_re"] / (fit["cov_re"] + fit["scale"])
        assert icc == pytest.approx(PINNED["icc"], abs=tol["icc"])
        assert fit["llf"] == pytest.approx(PINNED["llf"], abs=tol["llf"])

    def test_batched_device_path_matches_host(self):
        """The golden-section device solver agrees with the Brent host solver
        (and hence with the pinned oracle) on the same frozen data."""
        X, y, groups = _fixture()
        host = fit_random_intercept_reml(X, y, groups)
        dev = batched_lme_pvalues(X, np.tile(y, (3, 1)), groups)
        tol = GOLDEN_TOLERANCES
        for s in range(3):
            np.testing.assert_allclose(dev["beta"][s], host["params"],
                                       atol=tol["batched_vs_host_beta"])
            np.testing.assert_allclose(dev["bse"][s], host["bse"],
                                       atol=tol["batched_vs_host_bse"])
        np.testing.assert_allclose(dev["scale"], host["scale"], rtol=2e-3)


# ===========================================================================
# 3. exact randomisation test vs an independent MNE-semantics oracle
# ===========================================================================
def _mne_semantics_oracle(X, adjacency, tail, alpha=0.05):
    """Slow, independent implementation of the MNE cluster-1samp test with
    FULL sign enumeration: t threshold = t.ppf(1−α/(2 if tail==0 else 1),
    n−1); clusters = connected components of the supra-threshold graph;
    mass = sum of t; H0[s] = max |mass| under sign assignment s;
    p = mean(H0 ≥ |mass_obs|)."""
    n_subj, n_times, n_ch = X.shape
    n_nodes = n_times * n_ch
    Xf = X.reshape(n_subj, n_nodes).astype(np.float64)
    q = 1 - alpha / 2 if tail == 0 else 1 - alpha
    thr = stats.t.ppf(q, n_subj - 1)

    def tmap(xs):
        m = xs.mean(axis=0)
        sd = xs.std(axis=0, ddof=1)
        return m / np.maximum(sd / np.sqrt(n_subj), 1e-30)

    def clusters_and_masses(tv):
        out = []
        masks = []
        if tail >= 0:
            masks.append(tv > thr)
        if tail <= 0:
            masks.append(tv < -thr)
        for mask in masks:
            idx = np.flatnonzero(mask)
            if not len(idx):
                continue
            sub = adjacency[idx][:, idx]
            nc, lab = scipy.sparse.csgraph.connected_components(
                sub, directed=False)
            for c in range(nc):
                nodes = idx[lab == c]
                out.append((nodes, float(tv[nodes].sum())))
        return out

    obs = clusters_and_masses(tmap(Xf))
    H0 = np.zeros(2 ** n_subj)
    for s in range(2 ** n_subj):
        signs = np.where((s >> np.arange(n_subj)) & 1, 1.0, -1.0)
        cl = clusters_and_masses(tmap(signs[:, None] * Xf))
        H0[s] = max((abs(m) for _, m in cl), default=0.0)
    pv = np.array([np.mean(H0 >= abs(m)) for _, m in obs])
    return obs, pv, H0


class TestExactClusterPermutation:
    @pytest.mark.parametrize("tail", [0, 1])
    def test_matches_independent_oracle_exactly(self, tail):
        rng = np.random.default_rng(8)
        n_subj, n_times, n_ch = 8, 5, 4
        X = rng.standard_normal((n_subj, n_times, n_ch)).astype(np.float32)
        X[:, 1:3, 1:3] += 1.1                # plant a cluster
        spatial = scipy.sparse.csr_matrix(
            np.eye(n_ch, k=1, dtype=bool) + np.eye(n_ch, k=-1, dtype=bool))
        adj = combine_adjacency(n_times, spatial)

        t_obs, clusters, pv, H0 = cluster_permutation_1samp_test(
            X, adj, n_permutations=2 ** n_subj, tail=tail, exact=True)
        obs_o, pv_o, H0_o = _mne_semantics_oracle(X, adj, tail)

        assert len(clusters) == len(obs_o)
        # identical cluster memberships (order may differ → match by set)
        got = {frozenset(np.flatnonzero(c.ravel())) for c in clusters}
        want = {frozenset(nodes.tolist()) for nodes, _ in obs_o}
        assert got == want
        # sorted H0 distributions identical (f32 vs f64 tolerance)
        np.testing.assert_allclose(np.sort(H0), np.sort(H0_o),
                                   rtol=1e-4, atol=1e-4)
        # exact p-values: equal permutation counts → equal p
        got_p = sorted(np.round(pv, 10))
        want_p = sorted(np.round(pv_o, 10))
        np.testing.assert_allclose(got_p, want_p,
                                   atol=GOLDEN_TOLERANCES["cluster_p"])

    def test_auto_exact_switch(self):
        """n_permutations ≥ 2^n flips the engine into exact mode (as MNE
        does), making H0 deterministic regardless of seed."""
        rng = np.random.default_rng(9)
        X = rng.standard_normal((6, 4, 3)).astype(np.float32)
        spatial = scipy.sparse.csr_matrix(np.ones((3, 3), bool))
        adj = combine_adjacency(4, spatial)
        _, _, _, H0a = cluster_permutation_1samp_test(
            X, adj, n_permutations=50, tail=0, seed=1)
        assert len(H0a) == 51                 # 2^6 > 50: MC + observed
        _, _, _, E1 = cluster_permutation_1samp_test(
            X, adj, n_permutations=100, tail=0, seed=1)
        _, _, _, E2 = cluster_permutation_1samp_test(
            X, adj, n_permutations=100, tail=0, seed=2)
        assert len(E1) == 64                  # exact: all 2^6 assignments
        np.testing.assert_array_equal(E1, E2)
