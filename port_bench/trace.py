"""The traced window, reduced: what ran on the device and when, and what the
host was doing while the device sat idle.

`events` turns the profiler's raw events into plain tuples ``(kind, name,
start_ns, end_ns)``, where kind is ``device`` (a kernel, copy or fill on
the card), ``kernel`` is counted apart, or ``host`` (an operator, an
annotation or a runtime call); `reduce` works on those tuples alone, so
the CPU tests drive it with made-up events.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np

WINDOW = "port_bench.window"       # the annotation around the traced periods
DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "device", "gpu_memset": "device"}
HOST_KINDS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
TOP = 10                           # entries of each breakdown list
NAME_CHARS = 120


def _kind(e, cuda) -> str:
    """kernel, device, host, or None for an event that is none of these (a
    device-side copy of an annotation, the profiler's own overhead)."""
    if hasattr(e, "activity_type"):
        act = str(e.activity_type()).rsplit(".", 1)[-1].lower()
        return DEVICE_KINDS.get(act, "host" if act in HOST_KINDS else None)
    # a profiler without activity types: by device and name
    annotation = getattr(e, "is_user_annotation", None)
    if e.device_type() == cuda:
        if annotation is not None and annotation():
            return None
        return "device" if e.name().startswith(("Memcpy", "Memset")) else "kernel"
    return "host"


def events(prof) -> List[Tuple[str, str, int, int]]:
    """(kind, name, start_ns, end_ns) of every event of a finished
    `torch.profiler.profile`, kind one of kernel, device, host."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e, DeviceType.CUDA)
        if kind is None:
            continue
        start = e.start_ns()
        out.append((kind, e.name(), start, start + e.duration_ns()))
    return out


def _union(intervals: np.ndarray) -> np.ndarray:
    """Disjoint, sorted (start, end) rows covering the rows of `intervals`."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > reach[:-1]
    starts = iv[new, 0]
    ends = reach[np.r_[np.flatnonzero(new)[1:] - 1, len(iv) - 1]]
    return np.stack([starts, ends], axis=1)


def reduce(evts: Iterable[Tuple[str, str, int, int]]) -> dict:
    """The `WINDOW` annotation's span reduced: its length, the device's busy time (the union of every
    device operation's interval), the kernels launched, device seconds and
    calls by kernel name, the device operations that took most time and
    the longest idle gaps, each named by the innermost host event that
    covers its middle ("idle" where none does)."""
    evts = list(evts)
    spans = [(s, e) for kind, name, s, e in evts if kind == "host" and name == WINDOW]
    if not spans:
        raise ValueError(f"no {WINDOW!r} annotation in the trace")
    lo_ns, hi_ns = spans[0]
    dev = [(name, max(s, lo_ns), min(e, hi_ns), kind) for kind, name, s, e in evts
           if kind in ("kernel", "device") and name != WINDOW and e > lo_ns and s < hi_ns]
    by_name: dict = {}
    for name, s, e, _ in dev:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + (e - s) * 1e-9)
    busy = _union(np.array([(s, e) for _, s, e, _ in dev], dtype=np.int64).reshape(-1, 2))
    edges = np.concatenate([[lo_ns], busy.reshape(-1), [hi_ns]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    longest = gaps[np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")[:TOP]]
    host = np.array([(s, e) for kind, _, s, e in evts if kind == "host"],
                    dtype=np.int64).reshape(-1, 2)
    host_names = [name for kind, name, _, _ in evts if kind == "host"]
    idle_gaps = []
    for s, e in longest:
        mid = (s + e) // 2
        cover = np.flatnonzero((host[:, 0] <= mid) & (host[:, 1] >= mid))
        if len(cover):
            inner = cover[np.argmin(host[cover, 1] - host[cover, 0])]
            label = host_names[inner][:NAME_CHARS]
        else:
            label = "idle"
        idle_gaps.append([label, (e - s) * 1e-9])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {
        "window_s": (hi_ns - lo_ns) * 1e-9,
        "busy_s": float((busy[:, 1] - busy[:, 0]).sum()) * 1e-9,
        "launches": sum(1 for *_, kind in dev if kind == "kernel"),
        "kernels": by_name,
        "device_ops": [[name[:NAME_CHARS], t] for name, (_, t) in ops],
        "idle_gaps": idle_gaps,
    }
