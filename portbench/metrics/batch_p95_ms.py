"""batch_p95_ms: the 95th percentile over all batches of the window of a
batch's latency on the device's clock (portbench/serve.py): from the event
after the logits' copy of the batch in_flight places ahead, whose answer
lets the client call this one, to the event after its own logits' copy to
host memory; the wait behind the batches in flight ahead included."""

import statistics


def read(records):
    ms = records["window"]["latency_ms"]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=100, method="inclusive")[94]
