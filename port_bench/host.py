"""What a rank's threads did over the window of a cell of several cards.

`sample` and `used` read, for one process, what its threads did between
two points: each thread's CPU seconds (``/proc/self/task``), the context
switches (`resource.getrusage`) and the cgroup's CPU throttling
(``cpu.stat``), each where the host has it, beside the cores the process
may use and its intra-op threads.
"""

from __future__ import annotations

import os
import resource
import time
from typing import Dict, List

import torch

CGROUP_CPU_STAT = "/sys/fs/cgroup/cpu.stat"
TOP_THREADS = 8


def _tids() -> List[int]:
    try:
        return [int(t) for t in os.listdir("/proc/self/task")]
    except OSError:
        return [0]


def _thread_cpu() -> Dict[int, tuple]:
    """{tid: (name, CPU seconds, last core)} of this process's threads."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for tid in _tids():
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                text = f.read()
        except OSError:
            continue
        name = text[text.index("(") + 1:text.rindex(")")]
        rest = text[text.rindex(")") + 2:].split()
        # fields 14 and 15 (utime, stime) and 39 (processor), counted from 1
        out[tid] = (name, (int(rest[11]) + int(rest[12])) / tick, int(rest[36]))
    return out


def _cgroup_cpu() -> Dict[str, int]:
    try:
        with open(CGROUP_CPU_STAT) as f:
            return {k: int(v) for k, v in (line.split() for line in f if line.strip())}
    except (OSError, ValueError):
        return {}


def sample() -> dict:
    """What `used` measures from."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"t": time.perf_counter(), "threads": _thread_cpu(), "cgroup": _cgroup_cpu(),
            "cpu_s": ru.ru_utime + ru.ru_stime, "nvcsw": ru.ru_nvcsw, "nivcsw": ru.ru_nivcsw}


def used(before: dict, after: dict) -> dict:
    """Between two samples: the cores the process may use and its intra-op
    threads, wall seconds, the process's CPU seconds and context switches,
    the threads that used most CPU ([name, seconds, last core]), the
    threads alive, and the cgroup's throttled periods and microseconds."""
    top = []
    for tid, (name, cpu, core) in after["threads"].items():
        top.append([name, cpu - before["threads"].get(tid, (name, 0.0, core))[1], core])
    top.sort(key=lambda row: -row[1])
    cg0, cg1 = before["cgroup"], after["cgroup"]
    return {"cores": len(os.sched_getaffinity(0)), "intra_op_threads": torch.get_num_threads(),
            "wall_s": after["t"] - before["t"], "cpu_s": after["cpu_s"] - before["cpu_s"],
            "voluntary_switches": after["nvcsw"] - before["nvcsw"],
            "involuntary_switches": after["nivcsw"] - before["nivcsw"],
            "threads": len(after["threads"]), "top_threads": top[:TOP_THREADS],
            **{f"cgroup_{k}": cg1[k] - cg0.get(k, 0) for k in ("nr_throttled", "throttled_usec")
               if k in cg1}}
