"""The visualization suite: numpy in, PNG or HTML out. The port's
counterpart of vit_pruning_tpu/viz/, with its names and signatures;
matplotlib (and PIL for the report, streamlit for demo_app) are imported
only when a function is called."""

from vit_pruning_tpu_torch.viz.heatmaps import (  # noqa: F401
    mask_frequency,
    save_layer_heatmaps,
    skipped_heatmaps,
    to_skip_heatmaps,
    misclassified_heatmaps,
)
from vit_pruning_tpu_torch.viz.blackout import (  # noqa: F401
    blackout_image,
    blackout_montage,
    skips_per_layer_chart,
    layer_strips,
)
from vit_pruning_tpu_torch.viz.report import inference_report  # noqa: F401
