"""GiB that one synchronised main call allocates at its peak above what was
allocated before it, after the window (peak statistics reset first)."""


def read(records):
    b = records.get("main_peak_bytes")
    return None if b is None else b / 2**30
