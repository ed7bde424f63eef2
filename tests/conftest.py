"""Test configuration.

x64 is enabled for the numerics tests (the paper's solver is double
precision); all code under test is dtype-explicit so this only widens the
oracles.  Device count is left at 1 — multi-device tests spawn subprocesses
with their own ``--xla_force_host_platform_device_count`` (the dry-run, and
ONLY the dry-run, forces 512).

The subprocess-based distributed suites (domain decomposition, sharding
dry-runs) take minutes; they are auto-marked ``slow`` so a quick iteration
loop can deselect them with ``pytest -m "not slow"``."""

import jax
import pytest

jax.config.update("jax_enable_x64", True)

# modules / classes whose tests spawn multi-device subprocess dry-runs
_SLOW_MODULES = {"test_domain"}
_SLOW_CLASSES = {"TestParamSpecInference"}


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: slow multi-device subprocess tests (deselect with -m 'not slow')",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the repro_torch kernels); skips without one",
    )
    # The pre-facade entry points (stencil_create_2d & co, make_adi_operator*)
    # are deprecation shims for one release; the legacy-API suites exercise
    # them on purpose, so their warning is filtered here to keep tier-1
    # warning-clean.  The shim tests in tests/test_api.py still *assert* the
    # warning: pytest.warns / catch_warnings(record=True) override filters.
    config.addinivalue_line(
        "filterwarnings",
        "ignore:.*the unified four-function facade:DeprecationWarning",
    )


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.module.__name__ in _SLOW_MODULES or (
            item.cls is not None and item.cls.__name__ in _SLOW_CLASSES
        ):
            item.add_marker(pytest.mark.slow)
