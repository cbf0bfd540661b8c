"""The spans' reduction (`port_bench.spans.reduce`) on made-up events:
kernels by the span of their launching call, idle gaps by the span the
host was in, and what lies outside every span."""

import pytest

from port_bench import spans, trace


def _ev(kind, name, s, e, corr=0):
    return (kind, name, s, e, corr)


PATHS = {"step", "main", "main/dycore", "chem", "chem/row_block"}


def _events():
    return [
        _ev("host", trace.WINDOW, 0, 1000),
        _ev("host", "step", 0, 900),
        _ev("host", "main", 10, 600),
        _ev("host", "main/dycore", 100, 500),
        _ev("host", "chem", 610, 890),
        _ev("host", "chem/row_block", 620, 880),
        _ev("host", "aten::add", 110, 130),
        _ev("runtime", "cudaLaunchKernel", 115, 125, 1),   # in main/dycore
        _ev("runtime", "cudaLaunchKernel", 50, 60, 2),     # in main, outside dycore
        _ev("runtime", "cudaMemcpyAsync", 630, 640, 3),    # in chem/row_block
        _ev("runtime", "cudaLaunchKernel", 950, 960, 4),   # outside every span
        _ev("host", "aten::cat", 300, 420),
        _ev("kernel", "add_kernel", 200, 300, 1),          # runs after main/dycore's launch
        _ev("kernel", "copy_kernel", 60, 150, 2),
        _ev("device", "Memcpy HtoD", 650, 700, 3),
        _ev("kernel", "lonely", 965, 990, 4),
        _ev("kernel", "no_launch", 700, 720, 99),          # its launch not in the trace
        _ev("runtime", "cudaLaunchKernel", 870, 875, 5),   # in chem/row_block
        _ev("kernel", "late", 1005, 1010, 5),              # recorded past the window's end
    ]


def test_kernels_go_to_the_span_of_their_launch():
    r = spans.reduce(_events(), PATHS)
    by = r["by_span"]
    assert r["launches"] == 4 and r["window_s"] == pytest.approx(1e-6)
    assert r["kernel_events"] == 4 and r["kernels"]["late"] == 1
    assert by["main/dycore"]["launches"] == 1
    assert by["main/dycore"]["device_s"] == pytest.approx(100e-9)
    assert by["main"]["launches"] == 1 and by["main"]["device_s"] == pytest.approx(90e-9)
    # a copy is device time of its span, not a launch; a kernel the trace
    # places past the window is counted by its launch
    assert by["chem/row_block"]["launches"] == 1
    assert by["chem/row_block"]["device_s"] == pytest.approx(55e-9)
    assert spans.under(by, "main") == {"launches": 2, "device_s": pytest.approx(190e-9),
                                       "idle_s": pytest.approx(by["main"]["idle_s"]
                                                               + by["main/dycore"]["idle_s"])}


def test_gaps_go_to_the_span_the_host_was_in():
    r = spans.reduce(_events(), PATHS)
    by = r["by_span"]
    # busy [60, 150] + [200, 300] + [650, 720] + [965, 990]: gaps [0, 60],
    # [150, 200], [300, 650], [720, 965], [990, 1000]; middles 30 (main),
    # 175 and 475 (main/dycore), 842 (chem/row_block), 995 (none)
    assert by["main"]["idle_s"] == pytest.approx(60e-9)
    assert by["main/dycore"]["idle_s"] == pytest.approx(400e-9)
    assert by["chem/row_block"]["idle_s"] == pytest.approx(245e-9)
    assert r["busy_s"] == pytest.approx(285e-9)
    labels = dict(r["idle_gaps"])
    assert r["idle_gaps"][0] == ["main/dycore > idle", pytest.approx(350e-9)]
    assert labels["chem/row_block > idle"] == pytest.approx(245e-9)
    assert labels["main > idle"] == pytest.approx(60e-9)
    assert labels[f"{spans.UNATTRIBUTED} > idle"] == pytest.approx(10e-9)
    # a gap whose middle an operator covers is named after it
    r2 = spans.reduce(_events() + [_ev("host", "aten::mul", 460, 490)], PATHS)
    assert r2["idle_gaps"][0][0] == "main/dycore > aten::mul"


def test_kernels_launched_outside_every_span_are_unattributed():
    r = spans.reduce(_events(), PATHS)
    # `lonely` was launched after the step span; `no_launch`'s launch is
    # not in the trace: its device time is no span's either
    assert r["unattributed_launches"] == 1
    outside = r["by_span"][spans.UNATTRIBUTED]
    assert outside["launches"] == 1 and outside["device_s"] == pytest.approx(45e-9)
    assert sum(row["launches"] for row in r["by_span"].values()) == r["launches"]


def test_nested_spans_that_start_together():
    """A parent and its child opened at one instant: the child is the
    innermost from then on; where a sibling starts as another ends, the
    new one owns the instant."""
    evts = [_ev("host", trace.WINDOW, 0, 100), _ev("host", "main", 10, 90),
            _ev("host", "main/dycore", 10, 50), _ev("host", "main/physics", 50, 80),
            _ev("runtime", "cudaLaunchKernel", 10, 11, 1),
            _ev("runtime", "cudaLaunchKernel", 50, 51, 2),
            _ev("runtime", "cudaLaunchKernel", 85, 86, 3),
            _ev("kernel", "k1", 20, 30, 1), _ev("kernel", "k2", 55, 60, 2),
            _ev("kernel", "k3", 87, 88, 3)]
    r = spans.reduce(evts, {"main", "main/dycore", "main/physics"})
    assert {p: row["launches"] for p, row in r["by_span"].items() if row["launches"]} == {
        "main/dycore": 1, "main/physics": 1, "main": 1}


def test_reduce_needs_the_window():
    with pytest.raises(ValueError):
        spans.reduce([_ev("kernel", "k", 0, 1)], PATHS)
