"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated without accelerators, as prescribed in
SURVEY.md §4(d). Must run before jax is imported anywhere.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu", jax.devices()

# Persistent XLA compilation cache: the suite's cost is dominated by CPU
# compiles of the full model graph; repeat runs hit the cache. Safe to share
# across processes. Unless JAX_COMPILATION_CACHE_DIR places it, the cache
# is keyed on the host's CPU flags: XLA:CPU AOT entries compiled on a
# different machine type load with SIGILL-risk warnings, so a host move must
# start clean.
import hashlib  # noqa: E402

from mv3d_tpu.utils.compile_cache import setup_compile_cache  # noqa: E402

try:
    with open("/proc/cpuinfo") as f:
        _flags = next((ln for ln in f if ln.startswith("flags")), "")
except OSError:
    _flags = ""
_cache_dir = setup_compile_cache(hashlib.sha1(_flags.encode()).hexdigest()[:8])
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)

import time  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Quick-tier wall-clock budget: the quick tier
# (-m "not slow") is contracted to finish inside this many seconds on a
# loaded 1-core host; a run that blows the budget FAILS so slow tests get
# re-tiered instead of silently accreting. Override/disable with
# MV3D_QUICK_BUDGET_S (0 disables). Cold-cache runs (first run on a fresh
# host, .jax_cache empty) are exempt — compile time dominates there.
_SESSION_T0 = time.time()
_CACHE_WAS_WARM = os.path.isdir(_cache_dir) and bool(os.listdir(_cache_dir))


def pytest_configure(config):
    budget = os.environ.get("MV3D_QUICK_BUDGET_S")
    markexpr = getattr(config.option, "markexpr", "") or ""
    if budget is None and "not slow" in markexpr and _CACHE_WAS_WARM:
        budget = "720"
    config._mv3d_budget = float(budget) if budget else 0.0


def pytest_sessionfinish(session, exitstatus):
    budget = getattr(session.config, "_mv3d_budget", 0.0)
    dt = time.time() - _SESSION_T0
    if budget and dt > budget and exitstatus == 0:
        print(f"\nQUICK-TIER BUDGET EXCEEDED: {dt:.0f}s > {budget:.0f}s "
              f"— re-tier the offenders (pytest --durations=15 -m 'not "
              f"slow' names them) or move their compiles into shared "
              f"fixtures.")
        session.exitstatus = 1


@pytest.fixture
def rng():
    return np.random.RandomState(0)
