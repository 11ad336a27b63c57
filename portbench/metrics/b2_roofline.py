"""b2_roofline: kernel B2 (vpt::fused_vit_layer_cls_logits) over the traced
stretch: as b1_roofline, its work K and V over all B x S rows and the rest of
the layer, the final LN and the classifier over the B CLS rows."""

from portbench import trace, work


def read(records):
    if records["trace"] is None:
        return None
    m = records["model"]
    return trace.op_share(records["trace"], "vpt::fused_vit_layer_cls_logits",
                          lambda dims: work.b2_bound(m, dims[0][0], dims[0][1]))
