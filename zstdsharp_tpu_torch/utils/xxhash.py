"""The zstd frame checksum (counterpart of zstdsharp_tpu/utils/xxhash.py):
the low 32 bits of XXH64(content, seed 0), through the native engine's
``xxh64``."""

from __future__ import annotations

import numpy as np

from .. import native


def content_checksum(data: bytes | np.ndarray) -> int:
    """Frame checksum: low 32 bits of XXH64(content, 0)."""
    return native.xxh64(data) & 0xFFFFFFFF
