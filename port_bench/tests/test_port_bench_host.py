"""What a rank's threads did over a window (`port_bench.host`)."""

from port_bench import host


def test_a_process_sample():
    before = host.sample()
    sum(i * i for i in range(200_000))
    used = host.used(before, host.sample())
    assert used["wall_s"] > 0 and used["cpu_s"] >= 0 and used["threads"] >= 1
    assert used["cores"] >= 1 and used["intra_op_threads"] >= 1
    assert used["top_threads"] and all(row[1] >= 0 for row in used["top_threads"])
