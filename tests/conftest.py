"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Multi-device sharding is validated on virtual CPU devices, as
``__graft_entry__.dryrun_multichip`` does.  The persistent compilation
cache is placed by ``mba_tpu._config`` (``JAX_COMPILATION_CACHE_DIR`` or
``<checkout>/.jax_cache``).

Markers: ``slow`` (left out of the tier-1 run) and ``gpu`` (needs a CUDA
device: such a test skips here, deciding inside the test, never at import,
and ``chip_smoke.py`` runs the same path on the card).
"""
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import mba_tpu  # noqa: E402,F401  (places the compile cache)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running; not in tier-1")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; run on the card by "
        "chip_smoke.py")
