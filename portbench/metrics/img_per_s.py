"""img_per_s: images whose logits reached host memory in the window, over the
window's seconds (the host's clock, first call to last answer)."""


def read(records):
    w = records["window"]
    return w["images"] / w["seconds"] if w["images"] else None
