"""Test config: run on a virtual 8-device CPU mesh by default.

JAX_PLATFORMS defaults to cpu, and the 8 virtual CPU devices let the
sharding tests run without several cards.  Tests marked `gpu` need the
card: run them there with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

(the `gpu_device` fixture skips them on any other platform).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test on any other platform.  Decided here
    at run time, never at import, so every worker collects the same
    tests."""
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        pytest.skip(f'needs a GPU (JAX platform is {dev.platform!r})')
    return dev


@pytest.fixture(autouse=True, scope='module')
def _bound_jax_cache_growth():
    """Drop jit caches after every test MODULE.

    The full suite compiles ~200 distinct executables; around the ~160th
    the XLA CPU compiler aborts/segfaults inside backend_compile_and_load
    (reproduced twice at the same alphabetical position, never in
    isolation — cumulative compiler state, not a test bug).  Modules
    rarely share jitted shapes anyway, so clearing per module bounds the
    growth at negligible recompile cost."""
    yield
    jax.clear_caches()
