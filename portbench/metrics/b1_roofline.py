"""b1_roofline: kernel B1 (vpt::fused_vit_layer) over the traced stretch: the
least time of each call's work on an H100 (portbench/work.py's bound, from
the call's recorded input shape x [B, S, D] and the configuration's widths),
totalled, over the device time of the operations the calls launched."""

from portbench import trace, work


def read(records):
    if records["trace"] is None:
        return None
    m = records["model"]
    return trace.op_share(records["trace"], "vpt::fused_vit_layer",
                          lambda dims: work.b1_bound(m, dims[0][0], dims[0][1]))
