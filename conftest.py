"""Test configuration: an 8-device CPU mesh, and the ``gpu`` fixture.

SURVEY.md section 4: multi-card behavior is tested on CPU with
xla_force_host_platform_device_count=8; Pallas kernels run in interpreter
mode on the CPU (dirt_tpu.config.use_interpret). JAX is held to the CPU
unless ``DIRT_TEST_PLATFORMS`` names other platforms: tests marked ``gpu``
take the ``gpu`` fixture, which skips them where no card is visible. On a
machine with a card:

    DIRT_TEST_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import os

import pytest

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update(
    "jax_platforms", os.environ.get("DIRT_TEST_PLATFORMS", "cpu")
)

# Persistent compilation cache for the suite: tests re-jit many identical
# HLO programs (same kernels, same shapes, different test functions) and
# the cache is keyed by HLO hash, so it dedups compiles both within one
# run and across runs. JAX_COMPILATION_CACHE_DIR, when set, decides where.
from dirt_tpu.utils.compilecache import enable_compile_cache  # noqa: E402

enable_compile_cache()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU (run with DIRT_TEST_PLATFORMS=cuda,cpu)")
    return devices[0]
