"""The output check that decides `correct`: what the timed path served,
judged by the plain reference of the cell's model family (its `forward`,
portbench/families/<name>.py; the `vit` family's is portbench/reference.py).

For each pool batch, the last answer the window served is judged: its
logits (copied to the host in the window), its keep masks and its scores
(the entry's own outputs). The reference runs the same weights and pixels
in float32; at each layer where tokens drop it scores the live patches
itself, then follows the served keep mask, so that the logits compare the
same tokens. The first `prefix` tokens (CLS, registers) are never scored
and never dropped; scores index the positions after them. The numbers,
each held to its limit (portbench/limits/<cell>.json):

  logit_err      the worst image's ||served - reference|| / ||reference|| over its logits
  logit_err_median  the same of the median image (steadier from seed to seed)
  score_err      the largest |served - reference| predictor score of a live patch
  cut_violation  the largest amount by which a dropped live patch's reference
                 score exceeds a kept patch's (0 when the kept set is the top k)
  mask_faults    (layer, image) pairs whose keep mask breaks the schedule: a
                 prefix token dropped, another count than the schedule's, a
                 dropped token back, a change at a layer without a drop,
                 or a score where no live patch was scored (limit 0)

The first three exist only in cells where tokens drop. An image with a mask
fault, or whose own readings pass a limit, counts as failed.
"""

from __future__ import annotations

import torch

from portbench.work import live_tokens


def _mask_faults(masks: torch.Tensor, scores: torch.Tensor, m: dict, sched: list) -> torch.Tensor:
    """[B] bool: the images whose keep masks or scores break the schedule."""
    live, drops = live_tokens(m, sched)
    drop_at = {i for i, _ in drops}
    p = m["prefix"]
    bad = torch.zeros(masks.shape[1], dtype=torch.bool, device=masks.device)
    prev = torch.ones_like(masks[0])
    for i in range(m["layers"]):
        mk = masks[i]
        bad |= ~mk[:, :p].all(-1) | (mk.sum(-1) != live[i]) | (mk & ~prev).any(-1)
        if i not in drop_at:
            bad |= (mk != prev).any(-1) | torch.isfinite(scores[i].float()).any(-1)
        else:  # scores exactly at the live patches
            bad |= (torch.isfinite(scores[i].float()) != prev[:, p:]).any(-1)
        prev = mk
    return bad


def judge(params: dict, pool: torch.Tensor, served: list, m: dict, sched: list,
          limits: dict, products: dict, forward) -> dict:
    """served[j]: {'logits', 'keep_masks', 'scores'} of pool batch j (any
    device); products: the reference's precision (the `layers` and `other`
    of `forward`, the family's plain reference). Returns {'numbers': {name:
    value}, 'failed': images that fail, 'checked': images judged}."""
    _, drops = live_tokens(m, sched)
    p = m["prefix"]
    worst = {"logit_err": 0.0, "logit_err_median": 0.0, "mask_faults": 0}
    errs = []
    if drops:
        worst.update(score_err=0.0, cut_violation=0.0)
    failed = checked = 0
    dev = pool.device
    for j, out in enumerate(served):
        if out is None:
            continue
        masks = out["keep_masks"].to(dev)
        scores = out["scores"].to(dev)
        ref = forward(params, pool[j], m, sched, follow=masks, **products)
        logits = out["logits"].to(dev).float()
        err = ((logits - ref["logits"]).norm(dim=-1) / ref["logits"].norm(dim=-1))
        err = torch.nan_to_num(err, nan=float("inf"))
        bad = _mask_faults(masks, scores, m, sched)
        worst["mask_faults"] += int(bad.sum())
        worst["logit_err"] = max(worst["logit_err"], float(err.max()))
        errs.append(err)
        bad |= err > limits["logit_err"]
        for i, _ in drops:
            live = torch.isfinite(ref["scores"][i])
            s_ref = ref["scores"][i]
            gap = torch.where(live, (scores[i].float() - s_ref).abs(), torch.zeros_like(s_ref))
            gap = torch.nan_to_num(gap, nan=float("inf"))
            kept = masks[i][:, p:] & live
            dropped = ~masks[i][:, p:] & live
            lo = torch.where(kept, s_ref, torch.full_like(s_ref, float("inf"))).amin(-1)
            hi = torch.where(dropped, s_ref, torch.full_like(s_ref, float("-inf"))).amax(-1)
            cut = (hi - lo).clamp_min(0.0)
            worst["score_err"] = max(worst["score_err"], float(gap.amax()))
            worst["cut_violation"] = max(worst["cut_violation"], float(cut.max()))
            bad |= (gap.amax(-1) > limits["score_err"]) | (cut > limits["cut_violation"])
        failed += int(bad.sum())
        checked += bad.numel()
    if errs:
        worst["logit_err_median"] = float(torch.cat(errs).median())
    return {"numbers": worst, "failed": failed, "checked": checked}


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in numbers)
