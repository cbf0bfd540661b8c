"""The frozen counts reproduce the bounds the port's records give at config
5's per-card block (PERF.md, the table of kernels)."""

import pytest

from port_bench import counts


def test_k4_bound_at_the_block():
    # (nt, nz, ny, nx) = (107, 60, 500, 500), bytes-bound, with and without the limiter
    for pd in (False, True):
        t = counts.bound(*counts.tracers_bytes_ops(107, 60, 500, 500, pd))
        assert t * 1e3 == pytest.approx(7.767, abs=5e-4)


def test_k1_bound_at_the_block():
    # (60, 500, 500), padded to 506 x 506
    nbytes, _ = counts.adv_scalar_bytes_ops(60, 500, 500)
    assert nbytes == 4 * (3 * 60 * 506 * 506 + 61 * 500 * 500 + 60 + 60 * 500 * 500)
    assert counts.bound(*counts.adv_scalar_bytes_ops(60, 500, 500)) * 1e6 == pytest.approx(
        91.15, abs=5e-3)


def test_k2_bound_at_225m_elements():
    assert counts.bound(*counts.mie_bytes_ops(225_000_000)) * 1e3 == pytest.approx(
        3.140, abs=5e-4)


def test_k3_bound_at_7_5m_cells():
    assert counts.ros2_n_sub(60.0) == 2
    assert counts.bound(*counts.ros2_bytes_ops(7_500_000, 2)) * 1e3 == pytest.approx(
        1.970, abs=5e-4)


def test_step_least_time_counts_the_configuration():
    # config 4's package at the block: K4 3 x 7.77 ms, K1 3 x 0.09 ms, the
    # 9.676 GiB state read and written, a tenth of a chem call (Mie over
    # 4 bins x 30 bands, ROS2): ~33 ms a step
    state = int(9.676 * 2**30)
    least = counts.window_least_s((500, 500, 60), 107, 4, 2, state, 10, 1, 0) / 10
    assert 0.030 < least < 0.036
    kernels = counts.kernel_bounds((500, 500, 60), 107, 4, 2, 10, 1)
    assert set(kernels) == {"advect_scalar_5_3", "advect_tracers", "mie_cheb_eval",
                            "ros2_integrate"}
    assert kernels["mie_cheb_eval"] == pytest.approx(8 * 3.1399e-3, rel=1e-4)
    # no gas chemistry: no ROS2 bound; a rad call adds a read of the state
    assert "ros2_integrate" not in counts.kernel_bounds((500, 500, 60), 47, 4, 0, 10, 1)
    with_rad = counts.window_least_s((500, 500, 60), 47, 4, 0, state, 10, 1, 1)
    without = counts.window_least_s((500, 500, 60), 47, 4, 0, state, 10, 1, 0)
    assert with_rad - without == pytest.approx(state / counts.HBM_BYTES_PER_S)
