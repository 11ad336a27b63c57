"""Eval metric aggregation and log-compatible report formatting.

The port's own copy of vit_pruning_tpu/train/metrics.py (numpy, with pandas
imported only to format the tables): per-layer 2x2 predictor-vs-oracle
confusion matrices, the oracle skip ratio from their marginals, per-layer
MLP accuracy, the "Skip ratio / MLP accuracy" table and the interleaved
confusion-matrix dump, so that logs stay comparable with the reference's.
tests/test_torch_train.py holds it equal to the original.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class EvalAccumulator:
    """Accumulates per-batch counts on host (tiny transfers)."""

    def __init__(self, num_layers: int):
        self.num_layers = num_layers
        self.correct = 0
        self.total = 0
        self.confusion = np.zeros((num_layers, 2, 2), dtype=np.int64)
        self.kept_tokens = np.zeros(num_layers, dtype=np.int64)
        self.mask_total = np.zeros(num_layers, dtype=np.int64)

    def update(
        self,
        correct: int,
        batch: int,
        confusion: Optional[np.ndarray] = None,
        keep_masks: Optional[np.ndarray] = None,
    ):
        self.correct += int(correct)
        self.total += int(batch)
        if confusion is not None:
            self.confusion += np.asarray(confusion, dtype=np.int64)
        if keep_masks is not None:
            km = np.asarray(keep_masks)
            self.kept_tokens += km.sum(axis=(1, 2))
            self.mask_total += km.shape[1] * km.shape[2]

    # --- reference metric definitions (main_model_utils.py:263-268) ---

    @property
    def accuracy(self) -> float:
        return self.correct / max(self.total, 1)

    @property
    def oracle_skip_per_layer(self) -> np.ndarray:
        """Fraction of true 'skip' labels per layer: CM row-0 marginal
        (each_layer_skip, main_model_utils.py:264)."""
        row = self.confusion.sum(axis=2)  # [L, 2]: true-0 count, true-1 count
        tot = np.maximum(self.confusion.sum(axis=(1, 2)), 1)
        return row[:, 0] / tot

    @property
    def measured_skip_per_layer(self) -> np.ndarray:
        """Honest skip ratio from the actual masks (1 - kept fraction)."""
        return 1.0 - self.kept_tokens / np.maximum(self.mask_total, 1)

    @property
    def mlp_accuracy(self) -> float:
        """(TP + TN) / total over all layers (main_model_utils.py:266)."""
        tp = self.confusion[:, 1, 1].sum()
        tn = self.confusion[:, 0, 0].sum()
        return float((tp + tn) / (self.confusion.sum() + 1e-16))

    @property
    def mlp_accuracy_per_layer(self) -> np.ndarray:
        diag = self.confusion[:, 0, 0] + self.confusion[:, 1, 1]
        return diag / np.maximum(self.confusion.sum(axis=(1, 2)), 1)

    @property
    def class_accuracy_per_layer(self) -> np.ndarray:
        """[L, 2] per-class predictor accuracy: column 0 = 'skip' class
        (true label 0) recall, column 1 = 'keep' class (true label 1) recall
        — the M19 class_0_acc/class_1_acc diagnostics
        (mukunda/deit.py:183-229)."""
        skip = self.confusion[:, 0, 0] / np.maximum(self.confusion[:, 0].sum(axis=1), 1)
        keep = self.confusion[:, 1, 1] / np.maximum(self.confusion[:, 1].sum(axis=1), 1)
        return np.stack([skip, keep], axis=1)

    # --- report formatting (main_model_utils.py:270-294) ---

    def layer_table(self) -> str:
        """'Skip ratio / MLP accuracy' per-layer percentage table."""
        import pandas as pd

        df = pd.DataFrame(
            [self.oracle_skip_per_layer * 100, self.mlp_accuracy_per_layer * 100],
            index=["Skip ratio", "MLP accuracy"],
            columns=[f"L {i}" for i in range(self.num_layers)],
        ).round(1)
        return df.to_string()

    def confusion_table(self) -> str:
        """Normalized per-layer confusion matrices, interleaved layout."""
        cm = self.confusion / np.maximum(
            self.confusion.sum(axis=(1, 2), keepdims=True), 1
        )
        rows = []
        for r in range(2):
            cells = []
            for layer in range(self.num_layers):
                cells.append(
                    "  ".join(f"{np.trunc(cm[layer, r, c] * 1000) / 1000:.3f}" for c in range(2))
                )
            rows.append("   ".join(cells))
        return "\n".join(rows)

    def class_table(self) -> str:
        """M19 per-class ('skip'/'keep' recall) accuracy table
        (mukunda/deit.py:183-229 class_0_acc/class_1_acc)."""
        import pandas as pd

        ca = self.class_accuracy_per_layer * 100
        df = pd.DataFrame(
            [ca[:, 0], ca[:, 1]],
            index=["Skip-class acc", "Keep-class acc"],
            columns=[f"L {i}" for i in range(self.num_layers)],
        ).round(1)
        return df.to_string()

    def report(self) -> str:
        return (
            f"Skip %: {self.oracle_skip_per_layer.mean():.2%}\n"
            f"Overall accuracy of MLP: {self.mlp_accuracy:.2%}\n"
            + self.layer_table()
            + "\n\nPer-class predictor accuracy (M19):\n"
            + self.class_table()
            + "\n\nConfusion matrix for each layer:\n\n"
            + self.confusion_table()
            + f"\nOverall accuracy: {self.accuracy:.2%}\n"
        )


class MLPTracker:
    """M19's per-predictor running training diagnostics
    (mukunda/deit.py:158-231 `track_mlp_loss`): for each predictor MLP
    (one per layer), a running [samples, accuracy, positives, class-0
    ('skip') accuracy, class-1 ('keep') accuracy] aggregate, updated every
    train step from the per-layer confusion counts. The reference keeps the
    same five numbers per NeuralNet identity; here the whole table updates
    from one [L, 2, 2] device array per step."""

    def __init__(self, num_layers: int):
        self.num_layers = num_layers
        self.confusion = np.zeros((num_layers, 2, 2), dtype=np.int64)

    def update(self, confusion: np.ndarray):
        self.confusion += np.asarray(confusion, dtype=np.int64)

    @property
    def samples(self) -> np.ndarray:
        return self.confusion.sum(axis=(1, 2))

    @property
    def positives(self) -> np.ndarray:
        """Running count of 'keep' (class-1) oracle labels per predictor."""
        return self.confusion[:, 1].sum(axis=1)

    @property
    def accuracy(self) -> np.ndarray:
        diag = self.confusion[:, 0, 0] + self.confusion[:, 1, 1]
        return diag / np.maximum(self.samples, 1)

    @property
    def class_accuracy(self) -> np.ndarray:
        """[L, 2]: per-class (skip, keep) recall per predictor."""
        skip = self.confusion[:, 0, 0] / np.maximum(self.confusion[:, 0].sum(axis=1), 1)
        keep = self.confusion[:, 1, 1] / np.maximum(self.confusion[:, 1].sum(axis=1), 1)
        return np.stack([skip, keep], axis=1)

    def report(self) -> str:
        import pandas as pd

        ca = self.class_accuracy
        df = pd.DataFrame(
            {
                "samples": self.samples,
                "accuracy": np.round(self.accuracy * 100, 1),
                "positives": self.positives,
                "skip_acc": np.round(ca[:, 0] * 100, 1),
                "keep_acc": np.round(ca[:, 1] * 100, 1),
            },
            index=[f"mlp_{i}" for i in range(self.num_layers)],
        )
        return "Per-predictor training accuracy (M19):\n" + df.to_string()
