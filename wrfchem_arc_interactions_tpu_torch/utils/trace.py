"""Spans: which layer of the port a stretch of host and device time
belongs to.

``with span("dycore"): ...`` marks a layer.  Spans nest: a span's path is
its name joined to its parents' (``main/dycore/stage/acoustic``), except
that a span opened with ``step=`` (the run loop's ``step``) starts a model
step: it gives its step number to the spans inside it and is left out of
their paths.

Tracing is off by default, and then `span` returns one shared no-op
context: no allocation, no event, no profiler call.  `start` turns it on
for one device.  A span then takes the host clock (``perf_counter_ns``)
and records a timing event from a pool at its start and at its end, on
the stream that was the device's current one at `start`; under an active
`torch.profiler` it also enters ``record_function(path)``, so that the
trace shows its kernels inside it.
Nothing synchronises until `flush`.  `start` synchronises once and records
an anchor event beside a host timestamp, so every span's device start can
be put on the host's clock: a span's host lead (device start less host
start) says how far the host ran ahead of the card, and a lead near 0
marks a span whose host paces the card.  On the CPU the device times are
the host times.

The recorder is one per process (`start` ... `stop`): the spans sit in
layers that are called without it, so they find it here rather than as an
argument.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, List, Optional

import torch

from wrfchem_arc_interactions_tpu_torch.utils.device import DeviceLike, resolve_device, sync

_active: Optional["Recorder"] = None
# timing events by device, handed from one recorder to the next
_POOL: Dict[torch.device, List["torch.cuda.Event"]] = {}


class _NoSpan:
    """What `span` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def span(name: str, step: Optional[int] = None,
         report: Optional[Callable[[int, float], None]] = None):
    """A context that marks `name` as a layer; `NO_SPAN` while tracing is
    off.  `step` starts a model step (see the module docstring); `report`,
    if given, is called at `flush` as ``report(step, device seconds)``."""
    rec = _active
    if rec is None:
        return NO_SPAN
    return _Span(rec, name, step, report)


def enabled() -> bool:
    return _active is not None


def start(device: DeviceLike = None) -> "Recorder":
    """Turn tracing on for `device` (default ``cuda``)."""
    global _active
    if _active is not None:
        raise RuntimeError("tracing is already on")
    _active = Recorder(resolve_device(device))
    return _active


def stop() -> None:
    """Turn tracing off; spans not flushed are dropped."""
    global _active
    rec, _active = _active, None
    if rec is not None and rec.cuda and not rec.open:
        _POOL[rec.device] = rec.pool


def flush() -> Dict[str, dict]:
    """`Recorder.flush` of the recorder that is on."""
    if _active is None:
        raise RuntimeError("tracing is off")
    return _active.flush()


class _Span:
    __slots__ = ("rec", "name", "step", "report", "starts_step", "path", "parent",
                 "prof", "ev0", "ev1", "h0", "h1")

    def __init__(self, rec: "Recorder", name: str, step, report):
        self.rec, self.name, self.step, self.report = rec, name, step, report
        self.starts_step = step is not None

    def __enter__(self):
        rec = self.rec
        parent = rec.open[-1] if rec.open else None
        self.parent = parent
        if parent is None or parent.starts_step:
            self.path = self.name
        else:
            self.path = f"{parent.path}/{self.name}"
        if not self.starts_step and parent is not None:
            self.step = parent.step
        self.prof = None
        if torch.autograd._profiler_enabled():
            self.prof = torch.autograd.profiler.record_function(self.path)
            self.prof.__enter__()
        rec.open.append(self)
        self.ev0 = rec.event()
        self.h0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        self.h1 = time.perf_counter_ns()
        self.ev1 = rec.event()
        rec.open.pop()
        rec.done.append(self)
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    @property
    def host_s(self) -> float:
        """Host seconds from the span's start to its end."""
        return (self.h1 - self.h0) * 1e-9


class Recorder:
    """The spans of one device since `start` or the last `flush`."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.open: List[_Span] = []
        self.done: List[_Span] = []
        self.pool = _POOL.pop(device, []) if self.cuda else []
        self.stream = torch.cuda.current_stream(device) if self.cuda else None
        self._used = 0
        sync(device)
        self._anchor = self.event()
        self._anchor_ns = time.perf_counter_ns()

    def event(self):
        """A timing event from the pool, recorded on `stream` (None on the
        CPU)."""
        if not self.cuda:
            return None
        pool = self.pool
        if self._used == len(pool):
            pool.append(torch.cuda.Event(enable_timing=True))
        ev = pool[self._used]
        self._used += 1
        ev.record(self.stream)
        return ev

    def flush(self) -> Dict[str, dict]:
        """One synchronisation, then per path: ``count``; ``steps``, the
        model steps its spans belong to; ``device_ms`` and ``self_ms``
        (less the device time of the spans directly inside), totals over
        its spans; ``host_ms``; and ``lead_min_ms`` and ``lead_median_ms``,
        the host's lead over the device at its spans' starts.  Each
        span's `report` is called.  Then `discard`."""
        sync(self.device)
        done = self.done
        dev = {}
        for sp in done:
            if self.cuda:
                t0 = self._anchor.elapsed_time(sp.ev0)
                t1 = self._anchor.elapsed_time(sp.ev1)
                lead = t0 - (sp.h0 - self._anchor_ns) * 1e-6
            else:
                t0, t1, lead = sp.h0 * 1e-6, sp.h1 * 1e-6, 0.0
            dev[sp] = (t1 - t0, lead)
        inner: Dict[_Span, float] = {}
        for sp in done:
            if sp.parent is not None:
                inner[sp.parent] = inner.get(sp.parent, 0.0) + dev[sp][0]
        by_path: Dict[str, list] = {}
        for sp in done:
            by_path.setdefault(sp.path, []).append(sp)
        out = {}
        for path, spans in by_path.items():
            leads = [dev[sp][1] for sp in spans]
            device_ms = sum(dev[sp][0] for sp in spans)
            out[path] = {
                "count": len(spans),
                "steps": len({sp.step for sp in spans}),
                "device_ms": device_ms,
                "self_ms": device_ms - sum(inner.get(sp, 0.0) for sp in spans),
                "host_ms": sum(sp.h1 - sp.h0 for sp in spans) * 1e-6,
                "lead_min_ms": min(leads),
                "lead_median_ms": statistics.median(leads),
            }
        for sp in done:
            if sp.report is not None:
                sp.report(sp.step, dev[sp][0] * 1e-3)
        self.discard()
        return out

    def discard(self):
        """Drop the closed spans unread; their events are free for reuse
        (the anchor's and the open spans' are kept)."""
        self.done = []
        if self.cuda:
            keep = [self._anchor] + [sp.ev0 for sp in self.open]
            rest = [ev for ev in self.pool if all(ev is not k for k in keep)]
            self.pool[:] = keep + rest
            self._used = len(keep)
