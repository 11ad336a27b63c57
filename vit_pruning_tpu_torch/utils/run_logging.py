"""Run-name encoding, tee logging, stats.csv ledger.

A copy of vit_pruning_tpu/utils/run_logging.py (plain Python).

Keeps the reference's observability conventions so artifacts stay comparable:
  * run names encode all hyperparameters (himanshu/hi_main.py:110-113)
  * write_N_print tees to a per-run log file (main_model_utils.py:304-307)
  * stats.csv appends (run-name, accuracy, MLP accuracy) (hi_main.py:172-179)
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import Optional, Sequence


def encode_run_name(
    model_desc: str,
    train_type: str,
    variant: str,
    loss_types: Sequence[str],
    lrs: Sequence[float],
    sim_threshold: float,
    mlp_threshold: float,
    avg_threshold: float,
    batch_size: int,
    train_size: Optional[int],
    test_size: Optional[int],
    num_workers: int = 0,
    timestamp: Optional[str] = None,
) -> str:
    """hi_main.py:113 format, field for field."""
    ts = timestamp or datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    combined_lr = "^".join(map(str, lrs))
    combined_loss = "^".join(loss_types)
    return (
        f"{ts}_{model_desc}_{train_type}_{variant}_loss-{combined_loss}"
        f"_lr-{combined_lr}_st-{sim_threshold}_mt-{mlp_threshold}"
        f"_at-{avg_threshold}_bs-{batch_size}_trs-{train_size}_tes-{test_size}"
        f"_nw-{num_workers}"
    )


class RunLogger:
    """print + append to logs/<run-name>.txt (write_N_print equivalent).

    html=True additionally appends an HTML log per run (the loguru->HTML
    sink of mukunda/deit.py:30-51).
    """

    def __init__(
        self, run_name: str, log_dir: str = "logs", quiet: bool = False,
        html: bool = False,
    ):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{run_name}.txt")
        self._f = open(self.path, "a")
        self.quiet = quiet
        self._h = None
        if html:
            self.html_path = os.path.join(log_dir, f"{run_name}.html")
            new = not os.path.exists(self.html_path)
            self._h = open(self.html_path, "a")
            if new:
                self._h.write(
                    f"<html><head><title>{run_name}</title></head>"
                    "<body style='font-family:monospace;white-space:pre'>\n"
                )

    def __call__(self, s: str):
        if not self.quiet:
            print(s)
        self._f.write(s + "\n")
        self._f.flush()
        if self._h is not None:
            from datetime import datetime
            import html as _html

            ts = datetime.now().strftime("%H:%M:%S")
            self._h.write(f"<div><b>{ts}</b> {_html.escape(s)}</div>\n")
            self._h.flush()

    def close(self):
        self._f.close()
        if self._h is not None:
            self._h.close()


def append_stats(csv_path: str, run_name: str, accuracy: float, mlp_accuracy: float):
    """stats.csv results ledger (hi_main.py:172-179)."""
    new = not os.path.exists(csv_path)
    with open(csv_path, "a") as f:
        if new:
            f.write("Model, Accuracy, MLP Accuracy\n")
        f.write(f"{run_name}, {accuracy}, {mlp_accuracy}\n")
