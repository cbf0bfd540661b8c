"""The measured window: whole alarm periods of the run loop.

A period is `period_steps` model steps that hold the same work every time:
one call of each executable whose alarm divides the period.  The window
runs whole periods, each closed by a device synchronisation, and closes at
the period boundary nearest to the seconds asked for (at least one
period, and never past the ring of an alarm the period does not hold:
`max_periods`), so it never holds a fraction of a chem or rad call and its
mix never changes with the program's speed.

In the window's last period alone, before its last `follow` steps, a
`Snapshot` copies the state to pinned host memory on a stream of its own,
beside the program's work: the reference follows the window's last steps
from that copy.  Which period is the last is decided before it starts,
from the mean length of those before it, so the copy is taken once.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import torch


class Snapshot:
    """A host copy of a state dict, taken without stopping the device: on
    the card each field is copied on a side stream into pinned memory
    allocated once (`record_stream` keeps the field's memory from reuse
    until its copy is done)."""

    def __init__(self, state: dict, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.buffers = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=self.cuda)
                        for k, v in state.items()}
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.step = None

    def take(self, state: dict, step: int) -> None:
        if set(state) != set(self.buffers):
            raise KeyError(f"the state's fields changed: {sorted(set(state) ^ set(self.buffers))}")
        if not self.cuda:
            for k, v in state.items():
                self.buffers[k].copy_(v)
        else:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.stream):
                for k, v in state.items():
                    self.buffers[k].copy_(v, non_blocking=True)
                    v.record_stream(self.stream)
        self.step = step

    def state(self) -> dict:
        """The last copy (waits for it)."""
        if self.cuda:
            self.stream.synchronize()
        return self.buffers


def run_period(sim, period_steps: int, follow: int, snapshot: Optional[Snapshot] = None,
               phase_timing: bool = False) -> None:
    """One period of `sim`; with `snapshot`, the state copied before its
    last `follow` steps.  With `phase_timing` (each executable closed by a
    synchronisation of the whole device) the copy is waited for before the
    next step, outside the phases' times, which would otherwise take it in."""
    if snapshot is None:
        sim.advance(period_steps, phase_timing=phase_timing)
        return
    sim.advance(period_steps - follow, phase_timing=phase_timing)
    snapshot.take(sim.state, sim.step_idx)
    if phase_timing:
        snapshot.state()
    sim.advance(follow, phase_timing=phase_timing)


def timed_periods(period: Callable[[bool], None], sync: Callable[[], None], seconds: float,
                  max_periods: int, clock: Callable[[], float] = time.perf_counter,
                  agree: Optional[Callable[[bool], bool]] = None
                  ) -> Tuple[List[float], float]:
    """Run ``period(last)`` (then `sync`) until the window closes at the
    period boundary nearest to `seconds`, or after `max_periods`: (each
    period's seconds, seconds from the first period's start to the last
    one's synchronisation).  `last` is decided before the period starts:
    true where the boundary after it, predicted from the mean period so
    far, lies nearer to `seconds` than the one after that.  The first
    period's length is not known before it ran, so a window of a positive
    `seconds` holds two periods at least, where `max_periods` allows.
    On a mesh every rank runs this loop, and `agree` turns each rank's
    `last` into one that all ranks share (rank 0's), so that all run the
    same periods."""
    if max_periods < 1:
        raise ValueError("a window needs at least one period")
    t0 = last_t = clock()
    each: List[float] = []
    while True:
        n, elapsed = len(each), last_t - t0
        if n + 1 >= max_periods or seconds <= 0:
            last = True
        elif n == 0:
            last = False
        else:
            last = elapsed + 1.5 * elapsed / n >= seconds
        if agree is not None:
            last = agree(last)
        period(last)
        sync()
        now = clock()
        each.append(now - last_t)
        last_t = now
        if last:
            return each, now - t0


def max_periods(alarms, first: int, period_steps: int, cap: int) -> int:
    """Whole periods from step `first` that each hold the same calls: an
    alarm whose interval (in steps; 0 never rings) divides the period rings
    as often in each, any other must not ring at all, so the window ends
    before its next ring; at most `cap`."""
    n = cap
    for every in alarms:
        if every and period_steps % every:
            next_ring = -(-first // every) * every
            n = min(n, (next_ring - first) // period_steps)
    return n


def alarm_calls(every: int, first: int, steps: int) -> int:
    """Calls of an executable whose alarm rings every `every` steps (0:
    never) in model steps first .. first + steps - 1."""
    if not every:
        return 0
    return sum(1 for n in range(first, first + steps) if n % every == 0)
