"""Cluster-based sign-flip permutation testing on the device.

Replaces ``mne.stats.spatio_temporal_cluster_1samp_test`` /
``permutation_cluster_1samp_test`` (reference cbpa.py:1027-1042, joblib
``n_jobs=-1``) with a fully batched device implementation:

- **t-maps for ALL permutations are one matmul.**  For a 1-sample sign-flip
  test, Σ(s_i·x_i)² = Σx_i², so per-permutation variances come from the
  fixed Σx² and the permuted means — the only permutation-dependent work is
  ``signs (P, S) @ X (S, N)``, one matrix product.
- **Cluster search is iterative label propagation** over a static edge list
  (max-scatter per edge under a ``lax.while_loop``), vmapped over
  permutations.  Cluster mass = segment-sum of t over final labels; the
  null records each permutation's maximum mass.
- Observed clusters are labeled once on host (scipy connected components)
  and receive p-values against the device-computed null, with the observed
  statistic included in H0 exactly as MNE does.

Also provides the spatial adjacency builder (Delaunay over 2-D-projected
electrode positions — MNE's ``find_ch_adjacency`` analog), the temporal
chain combination, and circular phase wrap-around edges.
"""
from __future__ import annotations

import functools

import numpy as np
import scipy.sparse
import scipy.spatial
from scipy.stats import t as t_dist

import jax
import jax.numpy as jnp

from mba_tpu.channel_layout import eeg_positions_3d


# --------------------------------------------------------------------------
# adjacency construction (host)
# --------------------------------------------------------------------------
def delaunay_channel_adjacency(ch_names: list[str]) -> scipy.sparse.csr_matrix:
    """Spatial adjacency via Delaunay triangulation of projected positions.

    MNE's ``find_ch_adjacency`` analog (reference cbpa.py:235): electrode
    3-D positions are azimuthally projected to 2-D, triangulated, and
    triangle edges become adjacency.  Degenerate cases (< 4 channels) fall
    back to full connectivity.
    """
    pos = eeg_positions_3d(ch_names)
    # azimuthal equidistant projection (like MNE's _auto_topomap_coords)
    xyz = pos / np.linalg.norm(pos, axis=1, keepdims=True)
    theta = np.arccos(np.clip(xyz[:, 2], -1, 1))
    phi = np.arctan2(xyz[:, 1], xyz[:, 0])
    pts = np.stack([theta * np.cos(phi), theta * np.sin(phi)], axis=1)

    n = len(ch_names)
    adj = scipy.sparse.lil_matrix((n, n), dtype=bool)
    if n < 4:
        adj[:, :] = True
    else:
        tri = scipy.spatial.Delaunay(pts)
        for simplex in tri.simplices:
            for i in range(3):
                a, b = simplex[i], simplex[(i + 1) % 3]
                adj[a, b] = True
                adj[b, a] = True
    adj.setdiag(False)
    return adj.tocsr()


def combine_adjacency(n_times: int,
                      spatial_adj: scipy.sparse.spmatrix
                      ) -> scipy.sparse.csr_matrix:
    """Lattice product of a temporal chain with spatial adjacency.

    Node index convention: ``t * n_ch + ch`` (matches
    ``mne.stats.combine_adjacency``; reference cbpa.py:237).
    """
    n_ch = spatial_adj.shape[0]
    temporal = scipy.sparse.diags([np.ones(n_times - 1)] * 2, [-1, 1],
                                  format='csr', dtype=bool) \
        if n_times > 1 else scipy.sparse.csr_matrix((1, 1), dtype=bool)
    eye_t = scipy.sparse.eye(n_times, dtype=bool, format='csr')
    eye_c = scipy.sparse.eye(n_ch, dtype=bool, format='csr')
    combined = (scipy.sparse.kron(temporal, eye_c)
                + scipy.sparse.kron(eye_t, spatial_adj.astype(bool)))
    return combined.tocsr().astype(bool)


def add_phase_wraparound(adjacency: scipy.sparse.spmatrix, n_times: int,
                         n_ch: int) -> scipy.sparse.csr_matrix:
    """Circular edges joining the first and last phase bin per channel
    (reference cbpa.py:949-982)."""
    wrap = scipy.sparse.lil_matrix(adjacency.shape, dtype=bool)
    for ch in range(n_ch):
        first = ch
        last = (n_times - 1) * n_ch + ch
        wrap[first, last] = True
        wrap[last, first] = True
    return (adjacency.astype(bool) + wrap.tocsr()).astype(bool)


def _edge_list(adjacency: scipy.sparse.spmatrix) -> np.ndarray:
    coo = scipy.sparse.triu(adjacency.tocoo(), k=1)
    return np.stack([coo.row, coo.col], axis=1).astype(np.int32)


# --------------------------------------------------------------------------
# device kernels
# --------------------------------------------------------------------------
def _t_maps(signs, X_flat, sum_sq):
    """Per-permutation one-sample t-maps from the sign-flip matmul trick."""
    n_subj = X_flat.shape[0]
    mean = (signs @ X_flat) / n_subj                       # (P, N)
    var = (sum_sq[None, :] - n_subj * mean ** 2) / (n_subj - 1)
    se = jnp.sqrt(jnp.maximum(var, 1e-30) / n_subj)
    return mean / se


def _neighbor_table(edges: np.ndarray, n_nodes: int) -> np.ndarray:
    """Padded per-node neighbor-index table (n_nodes, max_degree).

    Padding entries point at the node itself, so a gather through the
    table is always in-bounds and padding never changes a max-reduction.
    Gathers compile and run orders of magnitude faster on the device than the
    equivalent edge-list scatter (vmapped scatter-max compile time blows
    up with the permutation batch width).
    """
    nbrs: list[list[int]] = [[] for _ in range(n_nodes)]
    for a, b in edges:
        if a != b:
            nbrs[a].append(int(b))
            nbrs[b].append(int(a))
    max_deg = max((len(x) for x in nbrs), default=1) or 1
    table = np.tile(np.arange(n_nodes, dtype=np.int32)[:, None],
                    (1, max_deg))
    for i, x in enumerate(nbrs):
        table[i, :len(x)] = x
    return table


def _max_cluster_mass(t_map, nbr_table, threshold, tail, n_nodes):
    """Maximum cluster mass for one t-map via gather-based label
    propagation with pointer jumping (Shiloach–Vishkin style): each
    supra-threshold node repeatedly (a) hooks to the max label among its
    supra neighbors and (b) shortcuts to its representative's label.
    Reach at least doubles per round, so ``ceil(log2(N)) + 2`` static
    rounds suffice — a fixed-trip unrolled loop, NO dynamic
    ``while_loop`` and NO scatters (whose vmapped compile time blows up
    with the permutation batch width)."""
    n_iters = int(np.ceil(np.log2(max(n_nodes, 2)))) + 2

    def mass_for(supra, tvals):
        labels = jnp.where(supra,
                           jnp.arange(n_nodes, dtype=jnp.int32), -1)

        # fully unrolled (≈11 rounds at 440 nodes): even fori_loop would
        # lower to an HLO While
        for _ in range(n_iters):
            nl = labels[nbr_table]                 # (n_nodes, max_deg)
            nbr_max = jnp.max(nl, axis=1)          # -1 neighbors ignored
            labels = jnp.where(labels >= 0,
                               jnp.maximum(labels, nbr_max), -1)
            # pointer jump: adopt the representative's (supra) label
            rep = jnp.where(labels >= 0, labels, 0)
            labels = jnp.where(labels >= 0,
                               jnp.maximum(labels, labels[rep]), -1)
        seg = jnp.where(labels >= 0, labels, 0)
        mass = jax.ops.segment_sum(jnp.where(supra, tvals, 0.0), seg,
                                   num_segments=n_nodes)
        return jnp.max(jnp.abs(mass))

    if tail == 1:
        return mass_for(t_map > threshold, t_map)
    if tail == -1:
        return mass_for(t_map < -threshold, t_map)
    # two-tailed: positive and negative clusters found separately (MNE)
    pos = mass_for(t_map > threshold, t_map)
    neg = mass_for(t_map < -threshold, t_map)
    return jnp.maximum(pos, neg)


@functools.partial(jax.jit,
                   static_argnames=("tail", "n_nodes", "n_permutations",
                                    "chunk"))
def _null_distribution(key, X_flat, nbr_table, threshold, tail, n_nodes,
                       n_permutations, chunk=256):
    """Max-cluster-mass null over sign-flip permutations (one program)."""
    n_subj = X_flat.shape[0]
    sum_sq = jnp.sum(X_flat ** 2, axis=0)
    n_chunks = -(-n_permutations // chunk)

    def chunk_fn(key_c):
        signs = jnp.where(
            jax.random.bernoulli(key_c, 0.5, (chunk, n_subj)), 1.0, -1.0
        ).astype(jnp.float32)
        tmaps = _t_maps(signs, X_flat, sum_sq)             # (chunk, N)
        return jax.vmap(
            lambda tm: _max_cluster_mass(tm, nbr_table, threshold, tail,
                                         n_nodes))(tmaps)

    keys = jax.random.split(key, n_chunks)
    out = jax.lax.map(chunk_fn, keys)
    return out.reshape(-1)[:n_permutations]


@functools.partial(jax.jit,
                   static_argnames=("tail", "n_nodes", "chunk"))
def _null_from_signs(signs, X_flat, nbr_table, threshold, tail, n_nodes,
                     chunk=256):
    """Max-cluster-mass null for an explicit sign matrix (P, n_subj) —
    used for exact enumeration of all 2^n sign assignments."""
    sum_sq = jnp.sum(X_flat ** 2, axis=0)
    n = signs.shape[0]
    pad = (-n) % chunk
    signs = jnp.concatenate(
        [signs, jnp.ones((pad, signs.shape[1]), signs.dtype)])

    def chunk_fn(sg):
        tmaps = _t_maps(sg, X_flat, sum_sq)
        return jax.vmap(
            lambda tm: _max_cluster_mass(tm, nbr_table, threshold, tail,
                                         n_nodes))(tmaps)

    out = jax.lax.map(chunk_fn, signs.reshape((-1, chunk,
                                               signs.shape[1])))
    return out.reshape(-1)[:n]


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------
def cluster_permutation_1samp_test(X: np.ndarray,
                                   adjacency: scipy.sparse.spmatrix,
                                   n_permutations: int = 1024,
                                   threshold: float | None = None,
                                   tail: int = 0,
                                   alpha_cluster_forming: float = 0.05,
                                   seed: int = 42,
                                   permutation_chunk: int = 256,
                                   exact: bool | None = None):
    """Spatio-temporal cluster-based 1-sample permutation test.

    X : (n_subjects, n_times, n_channels) contrast array.
    adjacency : combined (n_times·n_ch)² sparse adjacency
        (node index = t·n_ch + ch).
    permutation_chunk : permutations per ``lax.map`` step.  Execution
        time is nearly chunk-insensitive (the null is matmul + gather
        bound either way), but XLA compile time grows superlinearly
        with the vmapped chunk width.  256 keeps first-call latency low
        without costing throughput.
    exact : enumerate ALL 2^n_subjects sign assignments instead of Monte
        Carlo — the permutation p-values are then exact randomisation-test
        p-values (the identity assignment is included in H0, so p ≥ 2^-n).
        Defaults to automatic: exact when 2^n_subjects ≤ n_permutations.

    Returns (t_obs (n_times, n_ch), clusters [bool masks], cluster_pv,
    H0) with MNE conventions: cluster mass = sum of t inside the cluster;
    H0 includes the observed maximum; p = mean(H0 ≥ |mass|).
    """
    X = np.asarray(X, np.float32)
    n_subj, n_times, n_ch = X.shape
    n_nodes = n_times * n_ch
    if adjacency.shape != (n_nodes, n_nodes):
        raise ValueError(
            f"adjacency shape {adjacency.shape} does not match "
            f"n_times*n_ch = {n_nodes}")
    if threshold is None:
        df = n_subj - 1
        q = (1 - alpha_cluster_forming / 2 if tail == 0
             else 1 - alpha_cluster_forming)
        threshold = float(t_dist.ppf(q, df))

    X_flat = X.reshape(n_subj, n_nodes)

    # observed t-map (host; cheap)
    mean = X_flat.mean(axis=0)
    sd = X_flat.std(axis=0, ddof=1)
    t_obs_flat = mean / np.maximum(sd / np.sqrt(n_subj), 1e-30)

    # observed clusters via scipy connected components on the masked graph
    clusters: list[np.ndarray] = []
    masses: list[float] = []

    def find_clusters(supra_mask, tvals):
        idx = np.flatnonzero(supra_mask)
        if len(idx) == 0:
            return
        sub = adjacency[idx][:, idx]
        n_comp, labels = scipy.sparse.csgraph.connected_components(
            sub, directed=False)
        for c in range(n_comp):
            nodes = idx[labels == c]
            mask = np.zeros(n_nodes, bool)
            mask[nodes] = True
            clusters.append(mask.reshape(n_times, n_ch))
            masses.append(float(tvals[nodes].sum()))

    if tail in (0, 1):
        find_clusters(t_obs_flat > threshold, t_obs_flat)
    if tail in (0, -1):
        find_clusters(t_obs_flat < -threshold, t_obs_flat)

    # permutation null on device
    nbr_table = _neighbor_table(_edge_list(adjacency), n_nodes)
    if exact is None:
        exact = n_subj <= 20 and 2 ** n_subj <= n_permutations
    obs_max = max((abs(m) for m in masses), default=0.0)
    if exact:
        # all 2^n sign assignments; the identity (all +1) is one of them,
        # so H0 already contains the observed statistic
        bits = np.arange(2 ** n_subj, dtype=np.int64)
        signs = np.where((bits[:, None] >> np.arange(n_subj)) & 1,
                         1.0, -1.0).astype(np.float32)
        chunk = int(min(permutation_chunk, len(signs)))
        H0 = np.asarray(_null_from_signs(
            jnp.asarray(signs), jnp.asarray(X_flat),
            jnp.asarray(nbr_table), np.float32(threshold), tail, n_nodes,
            chunk=chunk))
    else:
        chunk = int(min(permutation_chunk, max(n_permutations, 1)))
        H0_perm = np.asarray(_null_distribution(
            jax.random.PRNGKey(seed), jnp.asarray(X_flat),
            jnp.asarray(nbr_table), np.float32(threshold), tail, n_nodes,
            n_permutations, chunk=chunk))
        H0 = np.concatenate([[obs_max], H0_perm])  # observed incl. (MNE)

    cluster_pv = np.array([float(np.mean(H0 >= abs(m))) for m in masses])
    return (t_obs_flat.reshape(n_times, n_ch), clusters, cluster_pv, H0)
