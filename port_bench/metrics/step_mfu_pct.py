"""The whole step's share of the card's peak [%]: the least time of the
profiled periods' work, counted from the configuration's shapes and the
periods' alarms (`port_bench.counts.window_least_s`: the four kernels'
bounds, the state read and written once a step, read once a rad call),
over the periods' measured time.  The same work is counted whatever
implements it."""

from port_bench import counts


def read(records):
    t = records.get("trace")
    if not t or not t["busy_s"]:
        return None
    n_sub = counts.ros2_n_sub(records["chemdt_s"]) if records["gas_chem"] else 0
    least = counts.window_least_s(records["shape"], records["scalars"], records["bins"],
                                  n_sub, records["state_bytes"], t["steps"],
                                  t["chem_calls"], t["rad_calls"])
    return 100.0 * least / t["window_s"]
