"""Tracing hooks: the port's copy of zstdsharp_tpu/utils/trace.py (the
reference keeps ZSTD_TRACE call sites with empty bodies,
ZstdCompress.cs:5658; here the hooks are live).

Register callbacks to observe frame lifecycle events; no cost beyond a
list test when no callback is registered.  For device-side profiling use
torch.profiler around the ops/ entry points.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

_emitters: list[Callable[["TraceEvent"], None]] = []


@dataclass
class TraceEvent:
    kind: str  # "compress_begin" | "compress_end" | "decompress_begin" | "decompress_end"
    src_size: int = 0
    dst_size: int = 0
    level: int | None = None
    strategy: int | None = None
    duration_s: float = 0.0
    extra: dict = field(default_factory=dict)


def register(fn: Callable[[TraceEvent], None]) -> None:
    _emitters.append(fn)


def unregister(fn: Callable[[TraceEvent], None]) -> None:
    _emitters.remove(fn)


def enabled() -> bool:
    return bool(_emitters)


def emit(event: TraceEvent) -> None:
    for fn in _emitters:
        fn(event)


class span:
    """Context manager emitting begin/end events around a codec call."""

    def __init__(self, kind: str, src_size: int = 0, **extra):
        self.kind = kind
        self.src_size = src_size
        self.extra = extra
        self.dst_size = 0

    def __enter__(self):
        if _emitters:
            emit(TraceEvent(f"{self.kind}_begin", src_size=self.src_size,
                            extra=self.extra))
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if _emitters:
            emit(TraceEvent(f"{self.kind}_end", src_size=self.src_size,
                            dst_size=self.dst_size,
                            duration_s=time.perf_counter() - self._t0,
                            extra=self.extra))
        return False
