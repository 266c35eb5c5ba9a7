"""Device bring-up: backend policy, no hidden fallbacks, compile-cache
placement, pandas-free device layers, chip_smoke.py phases at tiny size,
and acquisition processes that leave JAX alone."""
import json
import os
import shutil
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

TINY = replace(chip_smoke.STUDY, fs=256.0, n_eeg=3, n_emg=2, cmc_sec=12.0,
               cmc_grid_sec=6.0, n_trials=2, n_ica=4, n_subjects=2,
               trial_sec=20.0, silence_sec=4.0, control_sec=12.0,
               n_surrogates=200, surrogate_chunk=50, check_chunk=16,
               fft_null_surrogates=8)


def _python(code: str, env_extra=None, cwd=REPO):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "PYTHONPATH")}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


# ── backend policy ──────────────────────────────────────────────────────
class TestBackendPolicy:
    def test_cpu_entry(self):
        from mba_tpu.backend import backend_policy
        pol = backend_policy("cpu")
        assert pol.fft_flop_budget == 2e11
        assert backend_policy() == pol          # the tests run on the CPU

    def test_gpu_entry(self):
        from mba_tpu.backend import backend_policy
        pol = backend_policy("gpu")
        assert pol.fft_flop_budget > backend_policy("cpu").fft_flop_budget

    @pytest.mark.parametrize("platform", ["rocm", "metal", "npu"])
    def test_unknown_platform_raises(self, platform):
        from mba_tpu.backend import backend_policy
        with pytest.raises(RuntimeError, match="no backend policy"):
            backend_policy(platform)

    def test_auto_null_budget_comes_from_policy(self, monkeypatch):
        from mba_tpu.backend import BackendPolicy
        from mba_tpu.ops import cohort_null as CN
        rng = np.random.default_rng(0)
        eeg = rng.standard_normal((2, 2048, 2)).astype(np.float32)
        emg = rng.standard_normal((2, 2048, 2)).astype(np.float32)
        kw = dict(n_surrogates=16, window_length_sec=1.0, band=(8.0, 30.0),
                  surrogate_chunk=8)
        monkeypatch.setattr(CN, "backend_policy",
                            lambda: BackendPolicy(0.0))
        res = CN.cohort_msc_null(eeg, emg, 256.0, **kw)
        assert res["metadata"]["engine_choice"]["method_run"] == "rotation"
        assert res["metadata"]["engine_choice"]["fft_flop_budget"] == 0.0


# ── no hidden fallbacks ─────────────────────────────────────────────────
class TestNoFallback:
    def test_msc_program_failure_is_not_retried(self, monkeypatch):
        from mba_tpu.ops import coherence as C
        calls = []

        def boom(*a, **k):
            calls.append(1)
            raise RuntimeError("kernel failed")
        monkeypatch.setattr(C, "_msc_all_windows", boom)
        x = np.random.default_rng(0).standard_normal((1024, 2))
        with pytest.raises(RuntimeError, match="kernel failed"):
            C.multitaper_msc(x, x, 256.0)
        assert len(calls) == 1

    def test_coefficient_engine_failure_is_not_retried(self, monkeypatch):
        from mba_tpu.ops import gram_coeffs
        from mba_tpu.ops.cohort_null import cohort_msc_rotation_null
        calls = []

        def boom(*a, **k):
            calls.append(1)
            raise RuntimeError("gram failed")
        monkeypatch.setattr(gram_coeffs, "gram_coeffs_subject", boom)
        x = np.random.default_rng(1).standard_normal((1, 2048, 2))
        with pytest.raises(RuntimeError, match="gram failed"):
            cohort_msc_rotation_null(x, x, 256.0, n_surrogates=8,
                                     window_length_sec=1.0,
                                     band=(8.0, 30.0), coeff_engine="gram",
                                     overlap_upload=False)
        assert len(calls) == 1

    def test_profiling_block_propagates_errors(self):
        from mba_tpu.utils.profiling import StageTimer

        class Broken:
            def block_until_ready(self):
                raise RuntimeError("device fault")
        timer = StageTimer()
        with pytest.raises(RuntimeError, match="device fault"):
            timer.timed("stage")(Broken)()


# ── compile cache placement ─────────────────────────────────────────────
class TestCompileCache:
    CODE = ("import mba_tpu, jax, jax.numpy as jnp\n"
            "jax.config.update('jax_persistent_cache_min_compile_time_secs',"
            " 0)\n"
            "jax.jit(lambda x: jnp.sin(x) @ x)(jnp.ones((32, 32)))"
            ".block_until_ready()\n"
            "print(jax.config.jax_compilation_cache_dir)\n")

    def test_env_variable_places_the_cache(self, tmp_path):
        cache, home = tmp_path / "cache", tmp_path / "home"
        home.mkdir()
        out = _python(self.CODE, {"JAX_COMPILATION_CACHE_DIR": str(cache),
                                  "HOME": str(home)})
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip().splitlines()[-1] == str(cache)
        assert any(cache.iterdir())
        assert not any(home.iterdir())           # nothing under HOME

    def test_default_is_the_checkout(self, tmp_path):
        home = tmp_path / "home"
        home.mkdir()
        out = _python(self.CODE, {"HOME": str(home)})
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip().splitlines()[-1] == str(REPO / ".jax_cache")
        assert not any(home.iterdir())


# ── pandas-free device layers ───────────────────────────────────────────
@pytest.mark.parametrize("module", ["mba_tpu.ops", "mba_tpu.parallel",
                                    "mba_tpu.pipeline.preprocessing",
                                    "mba_tpu.ops.cohort_null"])
def test_device_layers_import_without_pandas(module):
    code = (f"import sys, importlib\nimportlib.import_module({module!r})\n"
            "bad = sorted(m for m in ('pandas', 'matplotlib', 'sklearn')"
            " if m in sys.modules)\nprint(bad)\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_chip_smoke_imports_only_the_guaranteed_packages():
    code = ("import sys\nsys.path.insert(0, 'tools')\nimport chip_smoke\n"
            "import mba_tpu.ops, mba_tpu.parallel, mba_tpu.ops.cohort_null\n"
            "import mba_tpu.pipeline.preprocessing, synth_study\n"
            "bad = sorted(m for m in ('pandas', 'matplotlib', 'sklearn', "
            "'statsmodels') if m in sys.modules)\nprint(bad)\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# ── chip_smoke.py at tiny size on the CPU ───────────────────────────────
@pytest.fixture(scope="module")
def meter():
    return chip_smoke.CompileMeter()


class TestChipSmokePhases:
    def test_cmc(self, meter):
        rec = chip_smoke.phase_cmc("cpu", meter, TINY)
        assert rec["epilogue"] == "xla"
        assert rec["max_abs_err"]["coherence"] <= 1e-4
        assert rec["grid_max_abs_err"]["ci"] <= 1e-3
        json.dumps(rec)

    def test_preprocess(self, meter):
        rec = chip_smoke.phase_preprocess("cpu", meter, TINY)
        assert rec["finite"]
        assert rec["g1_music_beta_cmc"] > rec["g1_threshold"]

    def test_cohort_null(self, meter):
        rec = chip_smoke.phase_cohort_null("cpu", meter, TINY)
        assert rec["p_fwe_planted"] < 0.01 < 0.05 < rec["p_fwe_control"]
        assert rec["chunk_max_stat_rel_err"] <= 1e-4
        assert rec["observed_map_max_abs_err"] <= 1e-4
        assert rec["fft_null"]["flop_per_sec"] > 0

    def test_four_cards_on_virtual_devices(self, meter):
        rec = chip_smoke.phase_four_cards("cpu", meter, TINY, n_dev=4)
        assert rec["cmc_max_abs_diff"] <= 1e-5
        assert rec["null_max_stat_max_abs_diff"] <= 1e-5
        assert rec["p_fwe"]["four"] == rec["p_fwe"]["one"]

    def test_refuses_to_run_without_a_gpu(self, capsys):
        assert chip_smoke.main([]) != 0
        assert capsys.readouterr().out == ""

    def test_fails_outside_a_checkout(self, tmp_path):
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        out = subprocess.run([sys.executable, "chip_smoke.py"],
                             cwd=tmp_path, env=env, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


# ── acquisition processes stay off JAX ──────────────────────────────────
def test_sampler_process_leaves_jax_uninitialised(tmp_path):
    code = (
        "import threading, multiprocessing as mp\n"
        "from mba_tpu.acquisition.sampling import dummy_sampling_process\n"
        "from jax._src import xla_bridge\n"
        "ev = threading.Event()\n"
        "threading.Timer(0.5, ev.set).start()\n"
        f"dummy_sampling_process({{}}, ev, {str(tmp_path)!r})\n"
        "print(xla_bridge.backends_are_initialized())\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "False"


# ── trace reduction ─────────────────────────────────────────────────────
def test_trace_summary_reads_a_recorded_trace(tmp_path):
    import jax
    import jax.numpy as jnp
    from mba_tpu.utils.profiling import trace_summary
    f = jax.jit(lambda x: (x @ x).sum())
    x = jnp.ones((128, 128))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(x).block_until_ready()
    summ = trace_summary(tmp_path, plane_prefix="/host:CPU")
    lines = summ["/host:CPU"]
    assert any(v["events"] > 0 for v in lines.values())
    assert all(v["busy_sec"] <= v["span_sec"] + 1e-12 for v in lines.values())
    with pytest.raises(FileNotFoundError):
        trace_summary(tmp_path / "missing")
