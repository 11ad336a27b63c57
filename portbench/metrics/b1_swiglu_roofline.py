"""b1_swiglu_roofline: kernel B1 (vpt::fused_vit_layer) on DINOv2's block
(the SwiGLU MLP on the gated epilogue, LayerScale) over the traced stretch:
the least time of each call's work on an H100 (families/dinov2.py's
b1_bound, the gated fc1 counted 2M wide, from the call's recorded input
shape x [B, S, D] and the configuration's widths), totalled, over the
device time of the operations the calls launched. The family's file is
loaded by path, as cells.family loads it."""

from pathlib import Path

from portbench import cells, trace


def read(records):
    if records["trace"] is None:
        return None
    m = records["model"]
    fam = cells.family(Path(__file__).resolve().parent.parent, "dinov2")
    return trace.op_share(records["trace"], "vpt::fused_vit_layer",
                          lambda dims: fam.b1_bound(m, dims[0][0], dims[0][1]))
