"""Run housekeeping: log GC, device pick, demo-fixture export (H11, H12, H14).

Mirrors vit_pruning_tpu/utils/housekeeping.py. Reference equivalents:
himanshu/remove_unwanted.py:1-18 (delete logs with <10 lines and their
checkpoints), himanshu/train.sh:1-9 (pick a GPU), himanshu/generate_test_data.py:1-27
(dump CIFAR test PNGs + labels.txt as demo fixtures).
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional, Tuple

import torch


def remove_unwanted(
    log_dir: str = "logs",
    models_dir: str = "models",
    min_lines: int = 10,
    dry_run: bool = False,
) -> List[str]:
    """Delete logs with fewer than `min_lines` lines and their checkpoints
    (remove_unwanted.py). Returns the removed run names."""
    removed = []
    if not os.path.isdir(log_dir):
        return removed
    for fname in os.listdir(log_dir):
        if not fname.endswith(".txt"):
            continue
        path = os.path.join(log_dir, fname)
        with open(path) as f:
            n = sum(1 for _ in f)
        if n < min_lines:
            run = fname[:-4]
            removed.append(run)
            if not dry_run:
                os.remove(path)
                ckpt = os.path.join(models_dir, run)
                if os.path.isdir(ckpt):
                    shutil.rmtree(ckpt)
                elif os.path.isfile(ckpt):  # the port's checkpoints are files
                    os.remove(ckpt)
                elif os.path.isfile(ckpt + ".pth"):
                    os.remove(ckpt + ".pth")
    return removed


def pick_device(index: Optional[int] = None) -> torch.device:
    """The train.sh GPU picker's role: the requested (or first) card as a
    torch.device. Raises when no card (or not that one) is present rather
    than falling back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("pick_device: no CUDA device is available")
    i = index or 0
    if i >= torch.cuda.device_count():
        raise RuntimeError(f"pick_device: card {i} asked for, {torch.cuda.device_count()} present")
    return torch.device("cuda", i)


def export_test_images(images, labels, out_dir: str = "test_data",
                       limit: int = 100) -> Tuple[str, str]:
    """Dump PNGs + labels.txt demo fixtures (generate_test_data.py).

    images: [N, H, W, 3] uint8; labels: [N] ints.
    """
    from PIL import Image

    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    label_path = os.path.join(out_dir, "labels.txt")
    with open(label_path, "w") as f:
        for i in range(min(limit, len(labels))):
            name = f"img_{i:05d}.png"
            Image.fromarray(images[i]).save(os.path.join(img_dir, name))
            f.write(f"{name} {int(labels[i])}\n")
    return img_dir, label_path
