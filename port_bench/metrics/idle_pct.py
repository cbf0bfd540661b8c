"""The share of the profiled periods [%] in which nothing ran on the card:
the window's length less the union of every kernel's, copy's and fill's
interval in the trace."""


def read(records):
    t = records.get("trace")
    if not t or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
