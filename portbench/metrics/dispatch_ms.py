"""dispatch_ms: host milliseconds inside the call of the served entry
(serving.py::serving_forward), totalled over the untraced window, over its
batches: the benchmark's own span around each call."""


def read(records):
    w = records["window"]
    return 1e3 * w["inside_s"] / w["batches"] if w["batches"] else None
