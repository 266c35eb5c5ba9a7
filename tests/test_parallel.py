"""Multi-chip sharding layer on the 8-device virtual CPU mesh.

Round-2 contract (VERDICT.md item 3): the sharded paths run the PRODUCTION
orchestrator — ``_msc_all_windows`` with masking, chunking and compaction —
so sharded == unsharded is asserted on the full result dict, and the
surrogate engines are sharded as themselves (``mesh=`` parameter), not via
a divergent kernel.
"""
import numpy as np
import pytest
import jax

from mba_tpu.parallel.mesh import make_mesh, cohort_sharding
from mba_tpu.parallel.cohort import cohort_multitaper_msc, time_sharded_msc
from mba_tpu.ops.coherence import multitaper_msc

FS = 256.0


def _cohort_signals(n_subjects=3, seconds=8.0, n_eeg=3, n_emg=2, seed=0):
    rng = np.random.default_rng(seed)
    n = int(FS * seconds)
    shared = rng.standard_normal(n)
    eeg = np.stack([0.5 * shared[:, None]
                    + rng.standard_normal((n, n_eeg))
                    for _ in range(n_subjects)]).astype(np.float32)
    emg = np.stack([0.5 * shared[:, None]
                    + rng.standard_normal((n, n_emg))
                    for _ in range(n_subjects)]).astype(np.float32)
    return eeg, emg


class TestMesh:
    def test_default_8_device_layout(self):
        mesh = make_mesh(8)
        assert mesh.axis_names == ("subjects", "windows")
        assert mesh.devices.shape == (2, 4)

    def test_explicit_axis_shapes(self):
        mesh = make_mesh(8, axis_shapes={"subjects": 4, "windows": 2})
        assert mesh.devices.shape == (4, 2)

    def test_cohort_sharding_spec(self):
        mesh = make_mesh(8)
        shard = cohort_sharding(mesh)
        assert shard.spec == jax.sharding.PartitionSpec("subjects",
                                                        "windows")


class TestCohortProductionOrchestrator:
    """cohort_multitaper_msc == per-subject multitaper_msc, exactly."""

    @pytest.mark.parametrize("aggregate_emg_max", [False, True])
    def test_matches_single_chip_full_dict(self, aggregate_emg_max):
        mesh = make_mesh(8)
        eeg, emg = _cohort_signals(n_subjects=3)   # 3 ∤ 2: subject padding
        res = cohort_multitaper_msc(
            mesh, eeg, emg, FS, nw=3, window_length_sec=1.0,
            overlap_frac=0.5, use_jackknife=True,
            aggregate_emg_max=aggregate_emg_max)
        for j in range(3):
            ref = multitaper_msc(
                eeg[j], emg[j], FS, nw=3, window_length_sec=1.0,
                overlap_frac=0.5, use_jackknife=True,
                aggregate_emg_max=aggregate_emg_max,
                apply_independence_threshold=False)
            np.testing.assert_allclose(
                res["coherence_raw"][j], ref["coherence_raw"],
                rtol=1e-5, atol=2e-6)
            np.testing.assert_allclose(
                res["coherence_ci_lower"][j], ref["coherence_ci_lower"],
                rtol=1e-5, atol=2e-6)
            np.testing.assert_allclose(
                res["coherence_ci_upper"][j], ref["coherence_ci_upper"],
                rtol=1e-5, atol=2e-6)
        np.testing.assert_allclose(res["freqs"], ref["freqs"])
        np.testing.assert_allclose(res["time_centers"],
                                   ref["time_centers"])

    def test_per_subject_masks(self):
        mesh = make_mesh(8)
        eeg, emg = _cohort_signals(n_subjects=2, seconds=6.0)
        W = int((eeg.shape[1] - FS) // (FS / 2) + 1)
        rng = np.random.default_rng(1)
        masks = rng.random((2, W)) < 0.6
        masks[1, :3] = False                       # asymmetric masks
        res = cohort_multitaper_msc(
            mesh, eeg, emg, FS, nw=3, window_length_sec=1.0,
            window_masks=masks, use_jackknife=True)
        for j in range(2):
            ref = multitaper_msc(
                eeg[j], emg[j], FS, nw=3, window_length_sec=1.0,
                window_mask=masks[j], use_jackknife=True,
                apply_independence_threshold=False)
            np.testing.assert_allclose(
                res["coherence_raw"][j], ref["coherence_raw"],
                rtol=1e-5, atol=2e-6)
            # masked-out windows are exact zeros
            assert np.all(res["coherence_raw"][j][~masks[j]] == 0)
        # cohort mean averages only the subjects active per window
        counts = masks.sum(axis=0).astype(np.float32)
        manual = (res["coherence_raw"].sum(axis=0)
                  / np.maximum(counts, 1)[:, None, None, None])
        np.testing.assert_allclose(res["cohort_mean"], manual,
                                   rtol=1e-6, atol=1e-7)

    def test_all_masked_out(self):
        mesh = make_mesh(8)
        eeg, emg = _cohort_signals(n_subjects=2, seconds=4.0)
        W = int((eeg.shape[1] - FS) // (FS / 2) + 1)
        masks = np.zeros((2, W), bool)
        res = cohort_multitaper_msc(mesh, eeg, emg, FS,
                                    window_length_sec=1.0,
                                    window_masks=masks)
        assert np.all(res["coherence_raw"] == 0)
        assert np.all(res["cohort_mean"] == 0)


class TestCompactOutput:
    """VERDICT r2 #6: masked-compact streaming instead of the dense
    (J, W, …) host materialization."""

    def _masked_setup(self, n_subjects=3, seconds=6.0):
        eeg, emg = _cohort_signals(n_subjects=n_subjects, seconds=seconds)
        W = int((eeg.shape[1] - FS) // (FS / 2) + 1)
        rng = np.random.default_rng(2)
        masks = rng.random((n_subjects, W)) < 0.3
        masks[0, :2] = True                     # ensure some activity
        return eeg, emg, masks

    def test_compact_matches_full_on_active_windows(self):
        mesh = make_mesh(8)
        eeg, emg, masks = self._masked_setup()
        kw = dict(nw=3, window_length_sec=1.0, window_masks=masks,
                  use_jackknife=True)
        full = cohort_multitaper_msc(mesh, eeg, emg, FS, **kw)
        comp = cohort_multitaper_msc(mesh, eeg, emg, FS,
                                     output="compact", **kw)
        for j, sub in enumerate(comp["subjects"]):
            act = sub["active_windows"]
            np.testing.assert_array_equal(act, np.nonzero(masks[j])[0])
            np.testing.assert_allclose(
                sub["coherence"], full["coherence_raw"][j][act],
                rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(
                sub["ci_upper"], full["coherence_ci_upper"][j][act],
                rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(comp["cohort_mean"],
                                   full["cohort_mean"],
                                   rtol=1e-6, atol=1e-7)
        assert comp["metadata"]["output"] == "compact"

    def test_artifact_streaming(self, tmp_path):
        mesh = make_mesh(8)
        eeg, emg, masks = self._masked_setup()
        comp = cohort_multitaper_msc(
            mesh, eeg, emg, FS, nw=3, window_length_sec=1.0,
            window_masks=masks, use_jackknife=True, output="compact",
            artifact_dir=tmp_path)
        ref = cohort_multitaper_msc(
            mesh, eeg, emg, FS, nw=3, window_length_sec=1.0,
            window_masks=masks, use_jackknife=True, output="compact")
        for j, sub in enumerate(comp["subjects"]):
            assert "path" in sub and sub["path"].endswith(".npz")
            loaded = np.load(sub["path"])
            np.testing.assert_allclose(loaded["coherence"],
                                       ref["subjects"][j]["coherence"],
                                       rtol=1e-7)
            np.testing.assert_array_equal(loaded["active_windows"],
                                          sub["active_windows"])
            assert "freqs" in loaded and "time_centers" in loaded

    def test_compact_bounds_host_memory(self):
        """Sparse task mask on a longer grid: the compact path must
        allocate an order of magnitude less host memory than the dense
        one would (the dense (J, W, …) tensors never exist)."""
        import tracemalloc
        mesh = make_mesh(8)
        n_subjects, seconds = 4, 120.0
        eeg, emg = _cohort_signals(n_subjects=n_subjects,
                                   seconds=seconds, n_eeg=4, n_emg=4)
        W = int((eeg.shape[1] - int(FS * 0.5)) // (FS / 4) + 1)
        masks = np.zeros((n_subjects, W), bool)
        masks[:, ::25] = True                     # 4 % active
        kw = dict(nw=3, window_length_sec=0.5, overlap_frac=0.5,
                  window_masks=masks, use_jackknife=True)
        # dense footprint the full mode would allocate on host:
        n_freqs = int(0.5 * FS) // 2 + 1
        dense_bytes = 3 * n_subjects * W * n_freqs * 4 * 4 * 4
        # warm (compiles + jax internals outside the measurement)
        cohort_multitaper_msc(mesh, eeg, emg, FS, output="compact", **kw)
        tracemalloc.start()
        cohort_multitaper_msc(mesh, eeg, emg, FS, output="compact", **kw)
        _, peak = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        # cohort_mean (W, F, 4, 4) is the irreducible dense piece; the
        # compact path must stay well under the 3-key dense cohort
        assert peak < dense_bytes / 3, (peak, dense_bytes)


class TestTimeSharded:
    """Halo-exchange time sharding == unsharded, window for window."""

    @pytest.mark.parametrize("overlap", [0.5, 0.0, 0.75])
    def test_matches_unsharded(self, overlap):
        mesh = make_mesh(8)
        rng = np.random.default_rng(2)
        n = int(FS * 10)
        eeg = rng.standard_normal((n, 2)).astype(np.float32)
        emg = rng.standard_normal((n, 2)).astype(np.float32)
        res = time_sharded_msc(mesh, eeg, emg, FS, nw=3,
                               window_length_sec=1.0,
                               overlap_frac=overlap, use_jackknife=True)
        ref = multitaper_msc(eeg, emg, FS, nw=3, window_length_sec=1.0,
                             overlap_frac=overlap, use_jackknife=True,
                             apply_independence_threshold=False)
        assert res["metadata"]["n_time_shards"] == 8
        assert res["metadata"]["halo_samples"] == int(FS * overlap)
        np.testing.assert_allclose(res["coherence_raw"],
                                   ref["coherence_raw"],
                                   rtol=1e-5, atol=2e-6)
        np.testing.assert_allclose(res["coherence_ci_upper"],
                                   ref["coherence_ci_upper"],
                                   rtol=1e-5, atol=2e-6)
        np.testing.assert_allclose(res["time_centers"],
                                   ref["time_centers"])

    def test_shards_hold_fraction_of_signal(self):
        """Each device's block is ~1/8 of the recording (the memory story)."""
        mesh = make_mesh(8)
        rng = np.random.default_rng(3)
        n = int(FS * 16)
        x = rng.standard_normal((n, 1)).astype(np.float32)
        res = time_sharded_msc(mesh, x, x.copy(), FS,
                               window_length_sec=1.0, overlap_frac=0.5,
                               use_jackknife=False)
        m = res["metadata"]
        assert m["samples_per_shard"] + m["halo_samples"] < 0.2 * n


class TestShardedPhaseRandomizedNull:
    """The REAL null engine under mesh= — one code path."""

    def _signals(self, couple, seed):
        rng = np.random.default_rng(seed)
        n = int(FS * 12)
        f = np.fft.rfftfreq(n, 1 / FS)
        spec = np.fft.rfft(rng.standard_normal(n))
        spec[(f < 15) | (f > 30)] = 0
        shared = np.fft.irfft(spec, n=n)
        shared /= shared.std() + 1e-12
        g = 0.8 if couple else 0.0
        eeg = (g * shared[:, None]
               + rng.standard_normal((n, 1))).astype(np.float32)
        emg = (g * shared[:, None]
               + rng.standard_normal((n, 1))).astype(np.float32)
        return eeg, emg

    def test_sharded_engine_matches_unsharded(self):
        from mba_tpu.ops.surrogate import msc_phase_randomized_null

        mesh = make_mesh(8)
        eeg, emg = self._signals(couple=False, seed=4)
        kw = dict(sampling_freq=FS, window_length_sec=1.0,
                  quantiles=(0.9, 0.95))
        sh = msc_phase_randomized_null(eeg, emg, n_surrogates=512,
                                       surrogate_chunk=32, seed=5,
                                       mesh=mesh, **kw)
        sh2 = msc_phase_randomized_null(eeg, emg, n_surrogates=512,
                                        surrogate_chunk=32, seed=5,
                                        mesh=mesh, **kw)
        np.testing.assert_array_equal(sh["max_stat"], sh2["max_stat"])

        un = msc_phase_randomized_null(eeg, emg, n_surrogates=512,
                                       surrogate_chunk=128, seed=5, **kw)
        np.testing.assert_allclose(sh["observed"], un["observed"],
                                   rtol=1e-5, atol=1e-6)
        assert sh["max_stat"].shape == un["max_stat"].shape == (512,)
        for q in (0.9, 0.95):
            a = float(np.quantile(sh["max_stat"], q))
            b = float(np.quantile(un["max_stat"], q))
            assert abs(a - b) < 0.1 * max(a, b)
        # per-cell quantile maps from the psum'd histogram agree too
        d = np.abs(sh["null_quantiles"][0.95] - un["null_quantiles"][0.95])
        assert np.median(d) < 0.05

    def test_null_below_planted_coupling(self):
        from mba_tpu.ops.surrogate import msc_phase_randomized_null

        mesh = make_mesh(8)
        eeg, emg = self._signals(couple=True, seed=6)
        res = msc_phase_randomized_null(
            eeg, emg, FS, n_surrogates=64, window_length_sec=1.0,
            surrogate_chunk=8, seed=7, max_stat_only=True, mesh=mesh)
        assert res["observed"].max() > np.quantile(res["max_stat"], 0.99)
