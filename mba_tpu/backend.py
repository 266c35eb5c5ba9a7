"""Per-platform policy: the one place a kernel or a value is chosen by device.

Keyed by ``jax.devices()[0].platform``.  A platform without an entry is an
error, never a silent fall-through to another platform's values.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax


@dataclass(frozen=True)
class BackendPolicy:
    # device FLOPs a full-FFT cohort null may cost before
    # ``cohort_null.cohort_msc_null(method="auto")`` switches to the
    # rotation engine: about one minute of achieved device rate
    fft_flop_budget: float


_POLICIES = {
    "cpu": BackendPolicy(fft_flop_budget=2e11),
    # the full-FFT null reached 8.86e11 FLOP/s (its cost model's count)
    # on an H100 80GB HBM3 at a 400 W power limit: × 60 s
    "gpu": BackendPolicy(fft_flop_budget=5.3e13),
}


def backend_policy(platform: str | None = None) -> BackendPolicy:
    """Policy of ``platform`` (default: the platform of the first device)."""
    if platform is None:
        platform = jax.devices()[0].platform
    try:
        return _POLICIES[platform]
    except KeyError:
        raise RuntimeError(
            f"no backend policy for platform {platform!r} "
            f"(known: {sorted(_POLICIES)})") from None
