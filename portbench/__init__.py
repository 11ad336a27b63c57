"""The benchmark of vit_pruning_tpu_torch's serving path on an H100 (see README.md)."""
