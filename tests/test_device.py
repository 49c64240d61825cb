"""device_bytes_limit: the memory budget the ECC lane groups and the
octave resize chunks are derived from."""

import jax
import pytest

from libstacker_tpu.utils import device


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats,want", [
    ({"bytes_limit": 60 << 30, "bytes_in_use": 1}, 60 << 30),
    ({"bytes_in_use": 1}, device._UNREPORTED_BYTES),
    (None, device._UNREPORTED_BYTES),
])
def test_bytes_limit_of_the_first_local_device(monkeypatch, stats, want):
    """The limit comes from the first LOCAL device: in a multi-process
    run jax.devices()[0] may be another process's device, whose stats
    cannot be read.  A backend that reports no limit gets the fixed
    assumption."""
    def not_addressable():
        raise AssertionError("jax.devices() must not be consulted")

    monkeypatch.setattr(jax, "devices", not_addressable)
    monkeypatch.setattr(jax, "local_devices", lambda: [_FakeDevice(stats)])
    assert device.device_bytes_limit() == want
