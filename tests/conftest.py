"""Test configuration: run JAX on a virtual 8-device CPU mesh so
multi-device sharding tests work without accelerators (SURVEY.md §4).

Markers: ``gpu`` marks a test that needs an NVIDIA GPU (it skips
elsewhere, decided inside the test by the ``gpu`` fixture); ``slow``
marks a test the tier-1 run leaves out (``-m 'not slow'``)."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
if not os.environ.get("LIBSTACKER_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"

import contextlib

import jax

if not os.environ.get("LIBSTACKER_TEST_GPU"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (run with LIBSTACKER_TEST_GPU=1)"
    )
    config.addinivalue_line(
        "markers", "slow: left out of the tier-1 run (-m 'not slow')"
    )


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided when the test runs)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (LIBSTACKER_TEST_GPU=1 on a card)")
    return jax.devices()[0]


class _KernelInterpret:
    """Routes ECC solves through the fused Triton kernel, run by the
    Pallas interpreter; ``off()`` restores the XLA path inside a
    ``with`` block."""

    def __init__(self, monkeypatch):
        import functools

        from libstacker_tpu.ops import ecc as ecc_ops, ecc_triton

        self._mp = monkeypatch
        self._ecc = ecc_ops
        self._orig_ok = ecc_ops._kernel_ok
        monkeypatch.setattr(ecc_ops, "_kernel_ok", lambda h, w: True)
        monkeypatch.setattr(
            ecc_triton, "ecc_iteration_moments",
            functools.partial(ecc_triton.ecc_iteration_moments,
                              interpret=True),
        )

    @contextlib.contextmanager
    def off(self):
        self._ecc._kernel_ok = self._orig_ok
        try:
            yield
        finally:
            self._ecc._kernel_ok = lambda h, w: True


@pytest.fixture
def ecc_kernel_interpret(monkeypatch):
    return _KernelInterpret(monkeypatch)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(12345)


@pytest.fixture(scope="session")
def noise_image(rng):
    """Smooth-ish random grayscale test image (uint8, 97x131 to exercise
    non-aligned shapes)."""
    import cv2

    img = rng.integers(0, 256, size=(97, 131), dtype=np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 1.5)


@pytest.fixture(scope="session")
def noise_rgb(rng):
    return rng.integers(0, 256, size=(64, 80, 3), dtype=np.uint8)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled executables between test FILES.

    Two consecutive full-suite runs (2026-08-20) segfaulted inside the
    XLA CPU backend while compiling an ECC slab program late in the
    suite (once in compilation_cache serialization, once in
    backend_compile_and_load) — the same test passes in every
    file-subset run, so the trigger is whole-suite accumulated compile
    state, not the test.  Clearing jit caches per module bounds the
    live LLVM-JIT'd program population; programs recompile on demand
    (fixtures holding device arrays are unaffected).
    """
    yield
    import gc

    import jax

    jax.clear_caches()
    gc.collect()
