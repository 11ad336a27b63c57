"""Static-HTML inference demo report (V6 equivalent).

The port's copy of vit_pruning_tpu/viz/report.py (numpy in, HTML out), held
equal to it by tests/test_torch_viz.py.

The reference ships a Streamlit app (interIIT/final_interiit.py: upload image
-> predicted class + 12 per-layer pruning images + bar chart of pruned
patches per layer). Streamlit is not available in every deployment, so the
same content is rendered to a self-contained HTML file; the interactive
Streamlit wrapper (viz/demo_app.py) reuses these pieces when streamlit is
installed.
"""

from __future__ import annotations

import base64
import io
import os
from typing import Optional, Sequence

import numpy as np


def _png_b64(fig) -> str:
    buf = io.BytesIO()
    fig.savefig(buf, format="png", bbox_inches="tight", dpi=100)
    import matplotlib.pyplot as plt

    plt.close(fig)
    return base64.b64encode(buf.getvalue()).decode()


def _img_b64(arr: np.ndarray) -> str:
    from PIL import Image

    a = np.asarray(arr)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0, 1) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def inference_report(
    images: Sequence[np.ndarray],
    keep_masks: np.ndarray,
    logits: np.ndarray,
    patch_size: int,
    class_names: Optional[Sequence[str]] = None,
    out_path: str = "inference_report.html",
) -> str:
    """Render predictions + per-layer blackouts + skip bar chart to HTML.

    images: B x [H, W, 3]; keep_masks: [L, B, S]; logits: [B, C].
    """
    from vit_pruning_tpu_torch.viz.blackout import blackout_montage, skips_per_layer_chart

    logits = np.asarray(logits)
    preds = logits.argmax(-1)
    km = np.asarray(keep_masks)

    parts = [
        "<html><head><title>vit_pruning_tpu inference report</title>",
        "<style>body{font-family:sans-serif;max-width:1100px;margin:2em auto}"
        "img{max-width:100%}h2{border-bottom:1px solid #ccc}</style></head><body>",
        "<h1>Token-skip inference report</h1>",
    ]

    def _name(c: int) -> str:
        return class_names[c] if class_names is not None else f"class {c}"

    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)

    # batch summary table (the reference demo's multi-image inference tab,
    # final_interiit.py:1009-)
    parts.append("<h2>Batch inference summary</h2>")
    parts.append(
        "<table border='1' cellpadding='4' style='border-collapse:collapse'>"
        "<tr><th>image</th><th>prediction</th><th>confidence</th>"
        "<th>mean skip</th></tr>"
    )
    for bi in range(len(images)):
        skip_bi = 100 * (1 - km[:, bi, 1:].mean())
        parts.append(
            f"<tr><td>{bi}</td><td>{_name(preds[bi])}</td>"
            f"<td>{probs[bi].max():.1%}</td><td>{skip_bi:.1f}%</td></tr>"
        )
    parts.append("</table>")

    fig, avg_skips = skips_per_layer_chart(km)
    parts.append("<h2>Average skipped patches per layer</h2>")
    parts.append(f'<img src="data:image/png;base64,{_png_b64(fig)}"/>')

    for bi, img in enumerate(images):
        parts.append(
            f"<h2>Image {bi}: predicted <b>{_name(preds[bi])}</b> "
            f"({probs[bi].max():.1%})</h2>"
        )
        top5 = np.argsort(probs[bi])[::-1][:5]
        parts.append(
            "<p>Top-5: "
            + ", ".join(f"{_name(int(c))} ({probs[bi, c]:.1%})" for c in top5)
            + "</p>"
        )
        parts.append(
            f'<img src="data:image/png;base64,{_img_b64(np.asarray(img))}" width="224"/>'
        )
        fig = blackout_montage(img, km[:, bi], patch_size)
        parts.append(f'<img src="data:image/png;base64,{_png_b64(fig)}"/>')

    parts.append(f"<p>Mean skip ratio: {100 * (1 - km[:, :, 1:].mean()):.1f}%</p>")
    parts.append("</body></html>")

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n".join(parts))
    return out_path
