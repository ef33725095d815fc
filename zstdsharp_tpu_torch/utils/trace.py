"""Tracing: lifecycle hooks of the host codec, and stage spans and counters
of the device planes.

Lifecycle hooks (``register``, ``span``): the port's copy of
zstdsharp_tpu/utils/trace.py (the reference keeps ZSTD_TRACE call sites
with empty bodies, ZstdCompress.cs:5658; here the hooks are live).
Register callbacks to observe frame lifecycle events; no cost beyond a list
test when no callback is registered.

Stage spans and counters (``stage``, ``add``, ``count``): the device
planes' entry points take a ``timings`` dict, the sink.  ``stage(name,
sink)`` adds the block's host wall seconds to ``sink[name]``; with
``sync=<device>`` a CUDA device is synchronised first, so a stage that
launches work ends when that work does.  ``add(name, seconds, sink)`` adds
a time taken elsewhere (a native call's own clock).  ``count(name, n,
sink)`` adds n to ``sink["n." + name]``.  A child span is named
``<parent>.<child>`` and runs inside its parent, so a parent's self time is
its value minus its children's.

The profiler rule: a span given ``plane=`` holds host work only, and while
torch.profiler records it also opens ``record_function("<plane>.<name>")``,
whose host event shares the device trace's clock, so an idle gap of the card
carries the name of the code that kept it idle.  Kineto copies an
annotation that encloses device work (a launch, a copy, a synchronise) onto
the device's timeline, where it would read as busy time; so a span that
encloses a CUDA call goes to the sink alone, and ``stage(name, None,
plane=)`` annotates the host stretch of such a stage by the same name.
With no sink and no profiler a span costs a None test and a flag test and
calls nothing in torch.
"""

from __future__ import annotations

import sys
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


# ---------------------------------------------------------------------------
# stage spans and counters
# ---------------------------------------------------------------------------


def profiling() -> bool:
    """Whether torch's profiler is recording (its module's own flag; no
    profiler can run before torch is imported)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


class _Off:
    """A span with nowhere to go."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Stage:
    __slots__ = ("name", "sink", "sync", "label", "_rf", "_t0")

    def __init__(self, name, sink, sync, label):
        self.name, self.sink, self.sync, self.label = name, sink, sync, label
        self._rf = None

    def __enter__(self):
        if self.label is not None:
            self._rf = sys.modules["torch.autograd.profiler"].record_function(
                self.label)
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:  # closed before the synchronise
            self._rf.__exit__(*exc)
        if self.sink is not None:
            if self.sync is not None and self.sync.type == "cuda":
                sys.modules["torch"].cuda.synchronize(self.sync)
            self.sink[self.name] = (self.sink.get(self.name, 0.0)
                                    + time.perf_counter() - self._t0)
        return False


def stage(name: str, sink: dict | None, sync=None, plane: str | None = None):
    """A span named `name` (see the module docstring): its wall seconds
    added to `sink[name]` when `sink` is a dict, `sync` (a torch device)
    synchronised at its end if it is a CUDA device; with `plane`, a host
    stretch that a running profiler also records as "<plane>.<name>"."""
    label = f"{plane}.{name}" if plane is not None and profiling() else None
    if sink is None and label is None:
        return _OFF
    return _Stage(name, sink, sync, label)


def add(name: str, seconds: float, sink: dict | None) -> None:
    """Add `seconds` timed elsewhere (a native call's own clock) to
    `sink[name]` when `sink` is a dict and `seconds` is not 0."""
    if sink is not None and seconds:
        sink[name] = sink.get(name, 0.0) + seconds


def count(name: str, n: int, sink: dict | None) -> None:
    """Add `n` to `sink["n." + name]` when `sink` is a dict."""
    if sink is not None:
        key = "n." + name
        sink[key] = sink.get(key, 0) + n
