"""Test configuration: a virtual 8-device CPU mesh (SURVEY.md §4,
"multi-host without a cluster").

The suite runs on the CPU. Set LQR_TESTS_ON_GPU=1 to leave JAX on its
default platform, which is how the ``gpu``-marked tests run on a card
(see README.md).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import jax  # noqa: E402

if not os.environ.get("LQR_TESTS_ON_GPU"):
    jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache (lqr_tpu.compile_cache): CPU compiles take
# seconds each, and the cache makes test reruns fast.
from lqr_tpu import compile_cache  # noqa: E402

compile_cache.enable()
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)


@pytest.fixture(autouse=True)
def _fresh_executable_arena(request):
    """Clear the in-memory executable caches at each module boundary.

    XLA:CPU's compiler has segfaulted once a long pytest process
    accumulated enough executables (the crash landed in
    backend_compile_and_load / compilation_cache.get_executable_and_time).
    Per-module clearing in conftest makes the mitigation independent of
    file ordering. The persistent disk cache keeps recompiles cheap."""
    mod = request.node.nodeid.split("::", 1)[0]
    if mod != getattr(_fresh_executable_arena, "_last", None):
        _fresh_executable_arena._last = mod
        jax.clear_caches()
    yield


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def random_image(rng, h, w, c, smooth=True):
    """A mildly smooth random uint8 image (smoothness gives non-degenerate
    seam structure; pure noise makes every seam equally bad)."""
    img = rng.integers(0, 256, (h, w, c)).astype(np.float32)
    if smooth:
        for _ in range(2):
            img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)
                   + np.roll(img, -1, 0) + np.roll(img, -1, 1)) / 5.0
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture
def make_image(rng):
    def _make(h=24, w=32, c=3, smooth=True):
        return random_image(rng, h, w, c, smooth)
    return _make
