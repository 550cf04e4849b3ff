"""Test env: CPU backend with 8 virtual devices for sharding tests.

Must run before jax initializes (standard JAX fake-mesh trick, SURVEY.md §4).

Tests that need a GPU carry the `gpu` marker and take the `gpu` fixture,
which skips them unless JAX runs on a GPU.  On a GPU host run them with
VCT_TEST_GPU=1, which keeps JAX's default backend instead of the CPU:

    VCT_TEST_GPU=1 python -m pytest -m gpu -n 0 tests/

(chip_smoke.py runs them first, in its own process.)
"""

import os

import pytest

ON_GPU = os.environ.get("VCT_TEST_GPU", "") == "1"

if not ON_GPU:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided per test, not
    at import, so every worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: VCT_TEST_GPU=1 on a GPU host")
