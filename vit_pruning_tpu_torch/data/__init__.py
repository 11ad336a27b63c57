"""Data: preprocessing, datasets and batchers (mirrors vit_pruning_tpu/data)."""

from vit_pruning_tpu_torch.data.preprocess import vit_preprocess, VIT_MEAN, VIT_STD  # noqa: F401
from vit_pruning_tpu_torch.data.datasets import (  # noqa: F401
    Batches,
    DeviceBatches,
    PrefetchBatches,
    load_cifar100,
    load_image_folder,
    synthetic_dataset,
)
