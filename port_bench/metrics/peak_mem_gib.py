"""The card's peak of allocated memory over the whole run [GiB], set-up
included (the caching allocator's `max_memory_allocated`)."""


def read(records):
    if records.get("peak_bytes") is None or "window" not in records:
        return None
    return records["peak_bytes"] / 2**30
