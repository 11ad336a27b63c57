"""Loss functions for skip predictors and classification.

Mirrors vit_pruning_tpu/train/losses.py, the reference's loss menu:
class-balanced BCE-with-logits against the oracle labels, MSE(cosine
similarity, 1 - score), MSE(score, mean CLS->patch attention), focal BCE,
cross-entropy, and the harness's distillation KL. As there, the predictor's
post-sigmoid scores are fed to the BCE as logits (the reference's double
squashing), so trained thresholds transfer unchanged.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist
import torch.nn.functional as F

# the process group over which a data-parallel step splits its batch
# (parallel/steps.py), set for the length of a step by `batch_group`
_BATCH_GROUP = contextvars.ContextVar("batch_group", default=None)


@contextlib.contextmanager
def batch_group(group):
    """Within the block, weighted_bce_oracle takes its label mean over the
    whole batch that `group`'s ranks hold in equal shards (None: this
    rank's batch is the whole batch)."""
    token = _BATCH_GROUP.set(group)
    try:
        yield
    finally:
        _BATCH_GROUP.reset(token)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor, pos_weight=1.0) -> torch.Tensor:
    """Mean BCE-with-logits with torch's pos_weight semantics:
    -[pos_weight * y * log s(x) + (1 - y) * log(1 - s(x))]."""
    per = -(pos_weight * labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits))
    return per.mean()


def weighted_bce_oracle(scores: torch.Tensor, keep_labels: torch.Tensor) -> torch.Tensor:
    """The predictor loss against the similarity oracle's keep labels
    [B, N] bool, with pos_weight = mean(labels) / (1 - mean(labels)).

    mean(labels) is a statistic of the whole batch: under data parallelism
    (inside `batch_group`) it is the mean over the group's equal shards, so
    that each rank's loss is its share of the single-process loss. No
    gradient flows through the labels."""
    labels = keep_labels.to(scores.dtype)
    focal_alpha = labels.mean()
    group = _BATCH_GROUP.get()
    if group is not None:
        dist.all_reduce(focal_alpha, group=group)
        focal_alpha = focal_alpha / dist.get_world_size(group)
    pos_weight = focal_alpha / (1.0 - focal_alpha + 1e-16)
    return bce_with_logits(scores, labels, pos_weight)


def focal_loss(probs: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
               gamma: float = 2.0) -> torch.Tensor:
    """Focal binary loss on probabilities."""
    targets = targets.to(probs.dtype)
    p = probs.clamp(1e-7, 1.0 - 1e-7)
    bce = -(targets * torch.log(p) + (1.0 - targets) * torch.log(1.0 - p))
    pt = p * targets + (1.0 - p) * (1.0 - targets)
    w = (1.0 - pt) ** gamma
    return (alpha * targets * w * bce + (1.0 - alpha) * (1.0 - targets) * w * bce).mean()


def mse_cosine_loss(scores: torch.Tensor, cos_similarity: torch.Tensor) -> torch.Tensor:
    """MSE(cos_sim, 1 - score): a token the layer barely changes is
    skippable, so its score should be low. cos_similarity is the detached
    teacher."""
    return ((cos_similarity - (1.0 - scores)) ** 2).mean()


def mse_attention_loss(scores: torch.Tensor, attn_target: torch.Tensor) -> torch.Tensor:
    """Regress the head-averaged CLS->patch attention row."""
    return ((scores - attn_target) ** 2).mean()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None].long()).mean()


def distillation_kl(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                    temperature: float = 2.0) -> torch.Tensor:
    """Hinton KD: T^2 * KL(softmax(t / T) || softmax(s / T))."""
    t = torch.log_softmax(teacher_logits / temperature, dim=-1)
    s = torch.log_softmax(student_logits / temperature, dim=-1)
    return temperature ** 2 * (torch.exp(t) * (t - s)).sum(-1).mean()
