"""Mesh-native cohort orchestration of the PRODUCTION CMC engine.

The functions here run the *same* device program as the single-device
orchestrator — ``_msc_all_windows`` with its masking, ``lax.map`` window
chunking and jackknife epilogue — under
``shard_map`` over a ``('subjects', 'windows')`` mesh, so sharded and
unsharded results are identical by construction (asserted in
tests/test_parallel.py).

Reference mapping: the reference loops subjects sequentially
(subject_feature_extraction_workflow.py:37) and parallelises permutations
via joblib (cbpa.py:1027-1042); here subjects and windows are mesh axes and
XLA collectives (one psum for the cohort mean) run between the devices.

Three entry points:

- :func:`cohort_multitaper_msc` — per-subject full CMC result dicts +
  cohort-mean coherence, subjects × windows sharded.
- :func:`time_sharded_msc` — ONE recording whose time axis exceeds a single
  device's memory, sharded along time with a (window − hop)-sample halo exchange
  (``ppermute``) so every sliding window is computed exactly once
  (SURVEY.md §5 "long-context" equivalent).
- the surrogate-null mesh path lives with its engine:
  ``ops.surrogate.msc_phase_randomized_null(mesh=...)`` and
  ``ops.cohort_null.cohort_msc_rotation_null(mesh=...)`` shard the
  surrogate axis over all devices — one engine, one code path.
"""
from __future__ import annotations

import math

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mba_tpu.ops.coherence import _auto_chunk, _msc_all_windows
from mba_tpu.ops.dpss import (filtered_tapers,
                              cmc_independence_threshold_host)
from mba_tpu.ops.framing import window_grid
from scipy.stats import t as _t_dist


def _mesh_axis(mesh: Mesh, name: str) -> int:
    return int(mesh.shape.get(name, 1))


def cohort_multitaper_msc(
        mesh: Mesh,
        eeg_cohort,
        emg_cohort,
        sampling_freq: float,
        nw: float = 3,
        window_length_sec: float = 1.0,
        overlap_frac: float = 0.5,
        taper_eigenvalue_threshold: float = 0.90,
        use_jackknife: bool = True,
        jackknife_alpha: float = 0.05,
        window_masks: np.ndarray | None = None,
        aggregate_emg_max: bool = False,
        window_chunk: int | None = None,
        output: str = "full",
        artifact_dir=None,
) -> dict:
    """Cohort CMC: the production orchestrator under a device mesh.

    eeg_cohort (J, n, E) / emg_cohort (J, n, M); optional per-subject
    boolean ``window_masks`` (J, W) on the global "cmc" grid — masked-out
    windows are zeros in the output, exactly as
    ``ops.coherence.multitaper_msc`` (same kernel, same compaction).

    output
        ``"full"`` (default): the single-chip result dict with a leading
        subject axis — a DENSE (J, W, …) host tensor per key.  At study
        scale (12 subjects × a 1-h window grid × 2049 freqs, jackknife
        on) that is ~12 GB of mostly zeros when windows are task-masked.
        ``"compact"``: per-subject dicts holding ONLY each subject's
        active windows (plus their ``active_windows`` indices), streamed
        off the device one subject at a time — peak host memory is one
        subject's compact result + the (W, …) cohort mean, never the
        dense cohort (asserted in tests/test_parallel.py).
    artifact_dir
        With ``output="compact"``: write each subject's compact result
        incrementally to ``artifact_dir`` as a timestamped ``.npz``
        (reference-style spectrogram artifact store,
        signal_features.py:1033-1100) and return the paths instead of
        the arrays — host memory then stays bounded regardless of J.

    Returns the result dict with ``cohort_mean`` — the per-window
    cross-subject mean coherence, averaged over the subjects whose mask
    includes each window.
    """
    if output not in ("full", "compact"):
        raise ValueError(f"output must be 'full' or 'compact', "
                         f"got {output!r}")
    if artifact_dir is not None and output != "compact":
        raise ValueError("artifact_dir requires output='compact'")
    eeg = np.asarray(eeg_cohort, np.float32)
    emg = np.asarray(emg_cohort, np.float32)
    if eeg.ndim != 3 or emg.ndim != 3 or eeg.shape[:2] != emg.shape[:2]:
        raise ValueError("cohort arrays must be (J, n_samples, n_channels) "
                         "with matching (J, n_samples)")
    J, n_samples, n_eeg = eeg.shape
    n_emg = emg.shape[2]

    window_samples = int(window_length_sec * sampling_freq)
    hop = int(window_samples * (1 - overlap_frac))
    if hop <= 0:
        raise ValueError("overlap_frac too high: hop_samples becomes <= 0")
    tapers = filtered_tapers(window_samples, nw, taper_eigenvalue_threshold)
    K = int(tapers.shape[0])
    if use_jackknife and K < 2:
        raise ValueError("jackknife requires at least 2 tapers")
    starts, time_centers = window_grid(
        n_samples, window_samples, hop, sampling_freq, convention="cmc")
    W = len(starts)
    freqs = np.fft.rfftfreq(window_samples, d=1.0 / sampling_freq)

    if window_masks is None:
        actives = [np.arange(W)] * J
    else:
        window_masks = np.asarray(window_masks, bool)
        if window_masks.shape != (J, W):
            raise ValueError(f"window_masks must be (J, {W}), "
                             f"got {window_masks.shape}")
        actives = [np.nonzero(m)[0] for m in window_masks]

    n_sub = _mesh_axis(mesh, "subjects")
    n_win = _mesh_axis(mesh, "windows")
    w_act_max = max((len(a) for a in actives), default=0)

    t_crit = np.float32(_t_dist.ppf(1 - jackknife_alpha / 2, max(K - 1, 1)))
    inv_fs_n = np.float32(1.0 / (sampling_freq * window_samples))
    tapers_j = jnp.asarray(tapers, jnp.float32)

    tail = (freqs.shape[0], n_eeg) if aggregate_emg_max \
        else (freqs.shape[0], n_eeg, n_emg)
    keys = ["coherence"] + (["ci_lower", "ci_upper"] if use_jackknife
                            else [])
    device_out = None

    if w_act_max > 0:
        chunk = window_chunk or _auto_chunk(window_samples, K, n_eeg,
                                            n_emg, use_jackknife)
        chunk = int(min(chunk, math.ceil(w_act_max / n_win)))
        w_pad = n_win * chunk * math.ceil(w_act_max / (n_win * chunk))
        j_pad = n_sub * math.ceil(J / n_sub)

        starts_pad = np.zeros((j_pad, w_pad), np.int32)
        for j in range(j_pad):
            act = actives[min(j, J - 1)]
            fill = starts[act[0]] if len(act) else starts[0]
            row = np.full(w_pad, fill, np.int64)
            row[:len(act)] = starts[act]
            starts_pad[j] = row
        eeg_pad = np.concatenate(
            [eeg, np.tile(eeg[-1:], (j_pad - J, 1, 1))]) if j_pad > J \
            else eeg
        emg_pad = np.concatenate(
            [emg, np.tile(emg[-1:], (j_pad - J, 1, 1))]) if j_pad > J \
            else emg

        def block(eb, mb, sb):
            def one(e, m, s):
                return _msc_all_windows(
                    e, m, s, tapers_j, inv_fs_n, t_crit,
                    window_samples, chunk, use_jackknife,
                    aggregate_emg_max)
            return jax.vmap(one)(eb, mb, sb)

        fn = shard_map(
            block, mesh=mesh,
            in_specs=(P("subjects"), P("subjects"),
                      P("subjects", "windows")),
            out_specs={k: P("subjects", "windows") for k in keys})
        # place each shard on its own device directly: a plain
        # jnp.asarray would stage the whole cohort on the first device
        subj = NamedSharding(mesh, P("subjects"))
        device_out = jax.jit(fn)(
            jax.device_put(eeg_pad, subj), jax.device_put(emg_pad, subj),
            jax.device_put(starts_pad,
                           NamedSharding(mesh, P("subjects", "windows"))))

    # cross-subject mean over the subjects active in each window
    counts = np.zeros(W, np.float32)
    for act in actives:
        counts[act] += 1.0
    denom = np.maximum(counts, 1.0).reshape((W,) + (1,) * len(tail))

    metadata = {
        "K_tapers": K,
        "n_subjects": J,
        "n_windows": W,
        "window_length_sec": window_length_sec,
        "overlap_frac": overlap_frac,
        "use_jackknife": use_jackknife,
        "mesh": dict(mesh.shape),
        "output": output,
    }

    if output == "compact":
        # stream one subject at a time off the device: peak host memory
        # is a single compact subject (+ the (W, …) cohort mean), never
        # the dense (J, W, …) cohort
        cohort_sum = np.zeros((W,) + tail, np.float32)
        subjects = []
        for j in range(J):
            act = actives[j]
            sub = {"active_windows": act}
            for k in keys:
                sub[k] = (np.asarray(device_out[k][j, :len(act)],
                                     np.float32)
                          if device_out is not None and len(act)
                          else np.zeros((len(act),) + tail, np.float32))
            cohort_sum[act] += sub["coherence"]   # act indices unique
            if artifact_dir is not None:
                from mba_tpu.utils import file_management as filemgmt
                from pathlib import Path
                adir = Path(artifact_dir)
                filemgmt.assert_dir(adir)
                path = adir / filemgmt.file_title(
                    f"Cohort CMC subject_{j:02} compact", ".npz")
                np.savez(path, time_centers=time_centers, freqs=freqs,
                         **sub)
                subjects.append({"path": str(path),
                                 "active_windows": act})
                del sub
            else:
                subjects.append(sub)
        return {
            "subjects": subjects,
            "cohort_mean": (cohort_sum / denom).astype(np.float32),
            "time_centers": time_centers,
            "freqs": freqs,
            "metadata": metadata,
        }

    full = {k: np.zeros((J, W) + tail, np.float32) for k in keys}
    if device_out is not None:
        dense = {k: np.asarray(v, np.float32)
                 for k, v in device_out.items()}
        for j in range(J):
            act = actives[j]
            for k in keys:
                full[k][j][act] = dense[k][j, :len(act)]
    cohort_mean = full["coherence"].sum(axis=0) / denom

    result = {
        "coherence_raw": full["coherence"],
        "cohort_mean": cohort_mean.astype(np.float32),
        "time_centers": time_centers,
        "freqs": freqs,
        "metadata": metadata,
    }
    if use_jackknife:
        result["coherence_ci_lower"] = full["ci_lower"]
        result["coherence_ci_upper"] = full["ci_upper"]
    return result


def time_sharded_msc(
        mesh: Mesh,
        eeg,
        emg,
        sampling_freq: float,
        nw: float = 3,
        window_length_sec: float = 1.0,
        overlap_frac: float = 0.5,
        taper_eigenvalue_threshold: float = 0.90,
        use_jackknife: bool = True,
        jackknife_alpha: float = 0.05,
        aggregate_emg_max: bool = False,
        window_chunk: int | None = None,
) -> dict:
    """CMC for ONE recording sharded along the time axis with halo exchange.

    For recordings whose (n_samples × channels) footprint exceeds a single
    device's memory, the signal is split into contiguous blocks of whole hops
    across all mesh devices; each device ``ppermute``-receives the first
    ``window − hop`` samples of its right neighbour (the halo) so sliding
    windows crossing a shard boundary are computed exactly once, locally.
    Results are bit-identical to the unsharded ``multitaper_msc`` grid
    (asserted in tests/test_parallel.py).
    """
    eeg = np.asarray(eeg, np.float32)
    emg = np.asarray(emg, np.float32)
    if eeg.ndim != 2 or emg.ndim != 2 or eeg.shape[0] != emg.shape[0]:
        raise ValueError("eeg/emg must be (n_samples, n_channels) with "
                         "equal n_samples")
    n_samples, n_eeg = eeg.shape
    n_emg = emg.shape[1]

    window_samples = int(window_length_sec * sampling_freq)
    hop = int(window_samples * (1 - overlap_frac))
    if hop <= 0:
        raise ValueError("overlap_frac too high: hop_samples becomes <= 0")
    halo = window_samples - hop
    tapers = filtered_tapers(window_samples, nw, taper_eigenvalue_threshold)
    K = int(tapers.shape[0])
    starts, time_centers = window_grid(
        n_samples, window_samples, hop, sampling_freq, convention="cmc")
    W = len(starts)
    freqs = np.fft.rfftfreq(window_samples, d=1.0 / sampling_freq)

    devices = mesh.devices.reshape(-1)
    n_dev = devices.size
    flat = Mesh(devices, ("time",))

    chunk = window_chunk or _auto_chunk(window_samples, K, n_eeg, n_emg,
                                        use_jackknife)
    w_loc = math.ceil(W / n_dev)
    chunk = int(min(chunk, w_loc))
    w_loc = chunk * math.ceil(w_loc / chunk)
    block = w_loc * hop

    # pad so every device holds `block` samples, plus the tail the last
    # device needs beyond the sharded extent (its halo neighbour wraps)
    n_shard = n_dev * block
    n_ext = n_shard + halo
    pad_to = lambda x: np.concatenate(
        [x, np.zeros((max(n_ext - n_samples, 0), x.shape[1]), x.dtype)]
    )[:n_ext]
    eeg_ext, emg_ext = pad_to(eeg), pad_to(emg)
    eeg_main, eeg_tail = eeg_ext[:n_shard], eeg_ext[n_shard:]
    emg_main, emg_tail = emg_ext[:n_shard], emg_ext[n_shard:]

    t_crit = np.float32(_t_dist.ppf(1 - jackknife_alpha / 2, max(K - 1, 1)))
    inv_fs_n = np.float32(1.0 / (sampling_freq * window_samples))
    tapers_j = jnp.asarray(tapers, jnp.float32)
    local_starts = jnp.asarray(np.arange(w_loc, dtype=np.int64) * hop,
                               jnp.int32)
    perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]

    def block_fn(eb, mb, et, mt):
        def extend(local, tail_rep):
            if halo == 0:
                return local
            recv = jax.lax.ppermute(local[:halo], "time", perm)
            idx = jax.lax.axis_index("time")
            is_last = (idx == n_dev - 1)
            h = jnp.where(is_last, tail_rep, recv)
            return jnp.concatenate([local, h], axis=0)

        e_ext = extend(eb, et)
        m_ext = extend(mb, mt)
        return _msc_all_windows(e_ext, m_ext, local_starts, tapers_j,
                                inv_fs_n, t_crit, window_samples, chunk,
                                use_jackknife, aggregate_emg_max)

    keys = ["coherence"] + (["ci_lower", "ci_upper"] if use_jackknife
                            else [])
    out_spec = {k: P("time") for k in keys}
    fn = shard_map(block_fn, mesh=flat,
                   in_specs=(P("time"), P("time"), P(), P()),
                   out_specs=out_spec)
    shard, rep = NamedSharding(flat, P("time")), NamedSharding(flat, P())
    out = jax.jit(fn)(jax.device_put(eeg_main, shard),
                      jax.device_put(emg_main, shard),
                      jax.device_put(eeg_tail, rep),
                      jax.device_put(emg_tail, rep))
    out = {k: np.asarray(v, np.float32)[:W] for k, v in out.items()}

    result = {
        "coherence_raw": out["coherence"],
        "time_centers": time_centers,
        "freqs": freqs,
        "metadata": {
            "K_tapers": K,
            "n_windows": W,
            "window_length_sec": window_length_sec,
            "overlap_frac": overlap_frac,
            "use_jackknife": use_jackknife,
            "halo_samples": halo,
            "n_time_shards": n_dev,
            "samples_per_shard": block,
        },
    }
    if use_jackknife:
        result["coherence_ci_lower"] = out["ci_lower"]
        result["coherence_ci_upper"] = out["ci_upper"]
    return result
