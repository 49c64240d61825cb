"""What the library asks of the device it runs on."""

from __future__ import annotations

import jax

# Memory assumed where the backend reports none (the CPU backend): the
# budgets derived from it only bound batch sizes, never correctness.
_UNREPORTED_BYTES = 8 << 30


def device_bytes_limit() -> int:
    """Bytes of device memory the first local device lets this process
    allocate (``memory_stats()["bytes_limit"]``).  Local: in a
    multi-process run ``jax.devices()[0]`` may belong to another
    process, and its stats cannot be read."""
    stats = jax.local_devices()[0].memory_stats()
    if not stats or "bytes_limit" not in stats:
        return _UNREPORTED_BYTES
    return int(stats["bytes_limit"])
