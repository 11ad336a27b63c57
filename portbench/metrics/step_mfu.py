"""step_mfu: the whole served forward's share of the card's bf16 peak: the
model's operations per image (portbench/work.py's model_flops) times the
images the untraced window completed, over its seconds, over 989 TFLOP/s.
An int8 cell is held against the bf16 peak too."""

from portbench import work


def read(records):
    w = records["window"]
    if not w["images"]:
        return None
    return 100.0 * records["flops_per_image"] * w["images"] / w["seconds"] / work.PEAK_BF16_FLOPS
