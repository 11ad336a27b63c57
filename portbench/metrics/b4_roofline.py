"""b4_roofline: kernel B4 (vpt::fused_vit_layer_int8) over the traced stretch:
as b1_roofline, its four products at the int8 peak and its attention at the
bf16 peak (portbench/work.py's b4_bound)."""

from portbench import trace, work


def read(records):
    if records["trace"] is None:
        return None
    m = records["model"]
    return trace.op_share(records["trace"], "vpt::fused_vit_layer_int8",
                          lambda dims: work.b4_bound(m, dims[0][0], dims[0][1]))
