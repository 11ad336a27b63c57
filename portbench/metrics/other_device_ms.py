"""other_device_ms: device milliseconds per batch of the program's device
operations launched outside every vpt:: operator's span (the embed, the
predictor, top-k and the gathers of selection and compaction, eager glue),
over the traced stretch's counted batches; the benchmark's logits copy is
not counted."""


def read(records):
    rec = records["trace"]
    if rec is None:
        return None
    total = sum(d["end"] - d["start"] for d in rec["device_ops"]
                if d["batch"] is not None and d["op"] is None and not d["harness"])
    return 1e3 * total / rec["stretch"]["batches"]
