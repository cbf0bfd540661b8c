"""Device allocations (cudaMalloc) the caching allocator made over the
traced window: each one a chance of a stall."""


def read(records):
    a = records.get("allocator", {})
    if "trace" not in records or "num_device_alloc" not in a:
        return None
    return a["num_device_alloc"]
