"""device_idle_share: 1 - (the union of the device operations' intervals) /
(the device timeline's wall time), in percent: the device timeline profiled
with CUDA activity alone (portbench/trace.py), from the end of one batch's
answer copy to the end of the last counted batch's."""

from portbench import trace


def read(records):
    tl = records["timeline"]
    if tl is None or tl["t1"] <= tl["t0"]:
        return None
    return 100.0 * (1.0 - trace.busy(tl) / (tl["t1"] - tl["t0"]))
