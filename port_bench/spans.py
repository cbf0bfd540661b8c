"""The port's spans (`wrfchem_arc_interactions_tpu_torch.utils.trace`) in
traced periods: which layer launched each kernel, owned its device time
and left each idle gap.

`traced_blocks` runs two blocks of periods with the spans on: (a) under
the profiler, where each span is a ``record_function`` of its path, and
(b) without it, where the spans' own timing events give each layer's
device time (`trace.flush`).  `reduce` works on block (a)'s events as
plain tuples ``(kind, name, start_ns, end_ns, correlation)``, so the CPU
tests drive it with made-up events: a launch, and the device time of the
kernel, copy or fill it started, belong to the innermost span around the
runtime call (the profiler gives the call and what it started one
correlation id), an idle gap to the innermost span the host was in at its
middle.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, List, Optional, Set, Tuple

import numpy as np

from port_bench import trace as trace_mod

UNATTRIBUTED = "unattributed"      # launched, or idle, outside every span
RUNTIME_KINDS = {"cuda_runtime", "cuda_driver"}


def _kind(e, cuda) -> str:
    """`port_bench.trace`'s kind, with the host's runtime and driver calls
    as ``runtime``."""
    kind = trace_mod._kind(e, cuda)
    if kind != "host":
        return kind
    if hasattr(e, "activity_type"):
        act = str(e.activity_type()).rsplit(".", 1)[-1].lower()
        return "runtime" if act in RUNTIME_KINDS else "host"
    return "runtime" if e.name().startswith("cu") else "host"


def events(prof) -> List[Tuple[str, str, int, int, int]]:
    """(kind, name, start_ns, end_ns, correlation id) of every event of a
    finished `torch.profiler.profile`, kind one of kernel, device, runtime,
    host."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e, DeviceType.CUDA)
        if kind is None:
            continue
        start = e.start_ns()
        out.append((kind, e.name(), start, start + e.duration_ns(), e.correlation_id()))
    return out


def _innermost(spans: np.ndarray):
    """For nested (start, end) rows: the times at which the innermost row
    changes, and from each the row's index (-1: none)."""
    marks = []
    for i, (s, e) in enumerate(spans):
        marks.append((s, 1, -(e - s), i))      # at one time: ends first, outer starts first
        marks.append((e, 0, 0, i))
    marks.sort()
    times, owner, stack = [], [], []
    for t, opening, _, i in marks:
        if opening:
            stack.append(i)
        else:
            stack.remove(i)
        times.append(t)
        owner.append(stack[-1] if stack else -1)
    return np.array(times, dtype=np.int64), np.array(owner, dtype=np.int64)


def _owner(times: np.ndarray, owner: np.ndarray, t: np.ndarray) -> np.ndarray:
    """The innermost row at each of the times `t` (-1: none)."""
    if len(times) == 0:
        return np.full(len(t), -1, dtype=np.int64)
    idx = np.searchsorted(times, t, side="right") - 1
    return np.where(idx >= 0, owner[np.maximum(idx, 0)], -1)


def reduce(evts: Iterable[Tuple[str, str, int, int, int]], paths: Set[str],
           window: str = trace_mod.WINDOW) -> dict:
    """The `window` annotation's span of block (a): its length; the kernel
    launch calls the host made in it (``launches``), those outside every
    span (``unattributed_launches``), and the kernels of those calls that
    the trace holds (``kernel_events``, by name under ``kernels``); by
    innermost span path (``by_span``, with `UNATTRIBUTED`): ``launches``,
    ``device_s`` of the kernels, copies and fills its calls launched, and
    ``idle_s``, the gaps in the device's busy union whose middle the host
    spent in it; and the longest gaps, each as ``<span path> > <innermost
    host event>``.  `paths` names the host annotations that are program
    spans.  Launches are counted from the host's calls, which the host's
    clock places in the window, and not from the device's records: the
    profiler drops a few of those, and places others past a window that
    ends in a synchronisation."""
    evts = list(evts)
    win = [(s, e) for kind, name, s, e, _ in evts if kind == "host" and name == window]
    if not win:
        raise ValueError(f"no {window!r} annotation in the trace")
    lo_ns, hi_ns = win[0]
    span_rows = [(s, e, name) for kind, name, s, e, _ in evts
                 if kind == "host" and name in paths and e > lo_ns and s < hi_ns]
    span_iv = np.array([(s, e) for s, e, _ in span_rows], dtype=np.int64).reshape(-1, 2)
    span_names = [name for *_, name in span_rows]
    times, owner = _innermost(span_iv)

    def path_at(t) -> List[str]:
        t = np.array(t, dtype=np.int64).reshape(-1)
        return [span_names[i] if i >= 0 else UNATTRIBUTED for i in _owner(times, owner, t)]

    by_span: dict = {}

    def entry(path):
        return by_span.setdefault(path, {"launches": 0, "device_s": 0.0, "idle_s": 0.0})

    calls = [(s, c) for kind, name, s, _, c in evts
             if kind == "runtime" and lo_ns <= s <= hi_ns]
    call_paths = dict(zip((c for _, c in calls), path_at([s for s, _ in calls])))
    for kind, name, s, _, c in evts:
        if kind == "runtime" and c in call_paths and "Launch" in name:
            entry(call_paths[c])["launches"] += 1
    kernels: dict = {}
    launched = {c for kind, *_, c in evts if kind == "runtime"}
    for kind, name, s, e, c in evts:
        if kind not in ("kernel", "device"):
            continue
        if c in call_paths:
            entry(call_paths[c])["device_s"] += (e - s) * 1e-9
            if kind == "kernel":
                kernels[name] = kernels.get(name, 0) + 1
        elif c not in launched and e > lo_ns and s < hi_ns:
            # its launch is not in the trace
            entry(UNATTRIBUTED)["device_s"] += (min(e, hi_ns) - max(s, lo_ns)) * 1e-9
    dev = np.array([(max(s, lo_ns), min(e, hi_ns)) for kind, _, s, e, _ in evts
                    if kind in ("kernel", "device") and e > lo_ns and s < hi_ns],
                   dtype=np.int64).reshape(-1, 2)
    busy = trace_mod._union(dev)
    edges = np.concatenate([[lo_ns], busy.reshape(-1), [hi_ns]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    mids = (gaps[:, 0] + gaps[:, 1]) // 2
    gap_paths = path_at(mids)
    for (s, e), path in zip(gaps, gap_paths):
        entry(path)["idle_s"] += (e - s) * 1e-9
    ops = [(s, e, name) for kind, name, s, e, _ in evts
           if kind in ("host", "runtime") and name != window and name not in paths]
    op_iv = np.array([(s, e) for s, e, _ in ops], dtype=np.int64).reshape(-1, 2)
    longest = np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")[:trace_mod.TOP]
    idle_gaps = []
    for g in longest:
        mid = mids[g]
        cover = np.flatnonzero((op_iv[:, 0] <= mid) & (op_iv[:, 1] >= mid))
        op = (ops[cover[np.argmin(op_iv[cover, 1] - op_iv[cover, 0])]][2] if len(cover)
              else "idle")
        label = f"{gap_paths[g]} > {op}"[:trace_mod.NAME_CHARS]
        idle_gaps.append([label, float(gaps[g, 1] - gaps[g, 0]) * 1e-9])
    return {
        "window_s": (hi_ns - lo_ns) * 1e-9,
        "busy_s": float((busy[:, 1] - busy[:, 0]).sum()) * 1e-9,
        "launches": sum(row["launches"] for row in by_span.values()),
        "unattributed_launches": by_span.get(UNATTRIBUTED, {}).get("launches", 0),
        "kernel_events": sum(kernels.values()),
        "kernels": kernels,
        "by_span": by_span,
        "idle_gaps": idle_gaps,
    }


def under(by_span: dict, path: str) -> dict:
    """``launches``, ``device_s`` and ``idle_s`` of `path` and every span
    inside it, summed."""
    out = {"launches": 0, "device_s": 0.0, "idle_s": 0.0}
    for p, row in by_span.items():
        if p == path or p.startswith(path + "/"):
            for k in out:
                out[k] += row[k]
    return out


def total(records: dict, paths, key: str) -> Optional[float]:
    """`key` summed over those of `paths` that a traced run's
    ``records["spans"]`` holds (on a mesh, seconds are the cards' sums),
    or None where it holds none of them."""
    rows = [records.get("spans", {}).get("paths", {}).get(p) for p in paths]
    rows = [r for r in rows if r is not None]
    return sum(r[key] for r in rows) if rows else None


def traced_blocks(sim, period: Callable[[], None], n_periods: int, cuda: bool,
                  sync: Optional[Callable[[], None]] = None) -> dict:
    """Block (a), then block (b), each of `n_periods` periods closed by
    `sync` (default: the device's synchronisation; on a mesh the harness's,
    which adds a barrier): (a) with the spans on under the profiler,
    reduced (`reduce`); (b) with the spans on and no profiler, the spans'
    summary (`trace.flush`).  Each with its mean period seconds."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from wrfchem_arc_interactions_tpu_torch.utils import trace

    sync = sync or sim.sync

    def periods() -> float:
        t0 = time.perf_counter()
        for _ in range(n_periods):
            period()
            sync()
        return (time.perf_counter() - t0) / n_periods

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    # each block starts with every queued step done, on a mesh every
    # rank's: a rank that is still reducing would hold the others' first
    # exchange, and the wait would read as their spans' time
    sync()
    trace.start(sim.device)
    try:
        with profile(activities=activities) as prof:
            with record_function(trace_mod.WINDOW):
                period_a = periods()
        paths = set(trace.flush())
    finally:
        trace.stop()
    reduced = reduce(events(prof), paths)
    del prof
    sync()
    trace.start(sim.device)
    try:
        period_b = periods()
        summary_b = trace.flush()
    finally:
        trace.stop()
    return {"a": dict(reduced, period_s=period_a), "b": {"spans": summary_b,
                                                          "period_s": period_b}}
