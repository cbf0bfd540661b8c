"""The whole-period window (with a fake clock), the alarms it may hold, the
snapshot on the CPU and the trace's reduction on made-up events."""

import pytest
import torch

from port_bench import trace, window


class FakeClock:
    def __init__(self, per_period):
        self.t, self.per = 0.0, per_period

    def __call__(self):
        return self.t

    def period(self):
        self.t += self.per


@pytest.mark.parametrize("seconds, want", [(10.0, 3), (11.0, 4), (0.0, 1), (1.4, 2),
                                           (100.0, 9)])
def test_window_closes_at_the_nearest_period_boundary(seconds, want):
    clock = FakeClock(3.0)
    syncs, lasts = [], []

    def period(last):
        lasts.append(last)
        clock.period()

    each, wall = window.timed_periods(period, lambda: syncs.append(1), seconds,
                                      max_periods=9, clock=clock)
    assert each == [3.0] * want and wall == 3.0 * want and len(syncs) == want
    # the last period, and only it, knew that it was the last before it ran
    assert lasts == [False] * (want - 1) + [True]


def test_window_needs_a_period():
    with pytest.raises(ValueError):
        window.timed_periods(lambda last: None, lambda: None, 5.0, 0)


def test_max_periods_keeps_foreign_alarms_out():
    # arc_block: chem every 10 steps (held by every period), rad every 100:
    # from step 2 the rad alarm rings at step 100, in the tenth period
    assert window.max_periods((10, 100), 2, 10, 50) == 9
    # chem and rad both every 10 steps: held by every period
    assert window.max_periods((10, 10), 2, 10, 50) == 50
    # an alarm that rings on 4 of every 10 steps cannot be held alike
    assert window.max_periods((4,), 2, 10, 50) == 0
    assert window.alarm_calls(10, 2, 90) == 9
    assert window.alarm_calls(100, 2, 90) == 0
    assert window.alarm_calls(0, 0, 90) == 0


class FakeSim:
    def __init__(self):
        self.state = {"t": torch.zeros(3)}
        self.step_idx = 0
        self.calls = []

    def advance(self, n, phase_timing=False):
        for _ in range(n):
            self.state = {"t": self.state["t"] + 1.0}
            self.step_idx += 1
        self.calls.append((n, phase_timing))


def test_period_copies_the_state_before_its_last_steps():
    sim = FakeSim()
    snap = window.Snapshot(sim.state, torch.device("cpu"))
    window.run_period(sim, 10, 2)           # a period that is not the last: no copy
    assert sim.calls == [(10, False)] and snap.step is None
    window.run_period(sim, 10, 2, snap)
    assert sim.calls == [(10, False), (8, False), (2, False)]
    assert snap.step == 18 and sim.step_idx == 20
    assert torch.equal(snap.state()["t"], torch.full((3,), 18.0))


def _ev(kind, name, s, e):
    return (kind, name, s, e)


def test_trace_reduce_busy_gaps_and_names():
    evts = [
        _ev("host", trace.WINDOW, 0, 1000),
        _ev("host", "aten::add", 100, 400),
        _ev("host", "cudaStreamSynchronize", 700, 900),
        _ev("kernel", "stage_kernel<0>", 50, 200),
        _ev("kernel", "stage_kernel<0>", 150, 300),     # overlaps the first
        _ev("device", "Memcpy DtoH", 500, 600),
        _ev("kernel", "limited_kernel<1>", 950, 1200),  # clipped at the window's end
    ]
    r = trace.reduce(evts)
    assert r["window_s"] == pytest.approx(1e-6)
    # busy: [50, 300] + [500, 600] + [950, 1000]
    assert r["busy_s"] == pytest.approx(400e-9)
    assert r["launches"] == 3
    assert r["kernels"]["stage_kernel<0>"][0] == 2
    assert r["kernels"]["stage_kernel<0>"][1] == pytest.approx(300e-9)
    gaps = dict((name, s) for name, s in r["idle_gaps"])
    # gaps [300, 500] (its middle, 400, ends aten::add), [600, 950] (the
    # synchronisation covers its middle) and [0, 50] (only the window's span)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(350e-9)
    assert r["idle_gaps"][0][0] == "cudaStreamSynchronize"
    assert r["device_ops"][0] == ["stage_kernel<0>", pytest.approx(300e-9)]
    assert gaps == {"aten::add": pytest.approx(200e-9),
                    "cudaStreamSynchronize": pytest.approx(350e-9),
                    trace.WINDOW: pytest.approx(50e-9)}


def test_trace_reduce_needs_the_window():
    with pytest.raises(ValueError):
        trace.reduce([_ev("kernel", "k", 0, 1)])
