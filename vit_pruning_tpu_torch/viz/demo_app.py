"""Streamlit demo app (V6): upload (or pick) an image, see the predicted
class name + top-5 probabilities, the per-layer pruning blackouts, the layer
strips, and the skipped-patches bar chart; plus a multi-image batch tab.

Run:  streamlit run vit_pruning_tpu_torch/viz/demo_app.py -- \
          [--checkpoint <path>] [--data_path <cifar100 dir>] [--device cuda|cpu]

The port's counterpart of vit_pruning_tpu/viz/demo_app.py, over the port's
pruned_vit_forward on `--device` (the card unless 'cpu' is asked for).
Structure mirrors interIIT/final_interiit.py: cached model/dataset loading
(@st.cache_* — :661-680), CIFAR-100 class-name map (:551-575), single-image
tab with predicted class + per-layer pruning images + bar chart (:700-1000),
and the multi-image batch-inference tab (:1009-). Gated: streamlit is
optional and imported only in main(); the same content is available
everywhere via viz.report.inference_report (cli.py viz).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    try:
        import streamlit as st
    except ImportError:
        print(
            "streamlit is not installed; use vit_pruning_tpu_torch.viz.report."
            "inference_report for the static-HTML demo instead.",
            file=sys.stderr,
        )
        return 1

    import numpy as np
    import torch

    from vit_pruning_tpu_torch.checkpoint import restore_checkpoint
    from vit_pruning_tpu_torch.configs import PruneConfig, vit_base_patch16_224
    from vit_pruning_tpu_torch.data.cifar100_labels import CIFAR100_FINE_LABELS
    from vit_pruning_tpu_torch.data.preprocess import pil_preprocess
    from vit_pruning_tpu_torch.models.convert import check_device
    from vit_pruning_tpu_torch.models.pruned_vit import init_pruned_vit_params, pruned_vit_forward
    from vit_pruning_tpu_torch.viz.blackout import (
        blackout_montage,
        layer_strips,
        skips_per_layer_chart,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--data_path", default=None,
                    help="CIFAR-100 pickle dir (test-image picker source)")
    ap.add_argument("--device", default="cuda")
    args, _ = ap.parse_known_args(argv)
    device = check_device(args.device)

    st.set_page_config(page_title="ViT token pruning demo", layout="wide")
    st.title("Dynamic token-skip ViT — per-layer pruning demo")

    @st.cache_resource
    def load_model():
        config = vit_base_patch16_224(num_labels=100)
        pcfg = PruneConfig(mode="mask", predictor="cls_mlp")
        params = init_pruned_vit_params(config, pcfg, torch.Generator().manual_seed(0), device)
        if args.checkpoint:
            params = restore_checkpoint(args.checkpoint, params)
        return params, config, pcfg

    @st.cache_data
    def load_test_images(n: int = 64):
        """Cached CIFAR-100 test images for the picker (final_interiit.py's
        bundled test set, :661-680). None when no --data_path."""
        if not args.data_path:
            return None
        from vit_pruning_tpu_torch.data.datasets import load_cifar100

        images, labels = load_cifar100(args.data_path, train=False, size=n)
        return images, labels

    params, config, pcfg = load_model()

    def class_name(c: int) -> str:
        if config.num_labels == 100:
            return CIFAR100_FINE_LABELS[int(c)]
        return f"class {int(c)}"

    @torch.no_grad()
    def predict(x):
        out = pruned_vit_forward(params, torch.from_numpy(x).to(device), config, pcfg)
        logits = out["logits"].float().cpu().numpy()
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs = probs / probs.sum(-1, keepdims=True)
        return out["keep_masks"].cpu().numpy(), probs

    def show_single(img224: np.ndarray, x):
        keep_masks, probs = predict(x)
        p = probs[0]
        top5 = np.argsort(p)[::-1][:5]
        st.subheader(f"Predicted: {class_name(top5[0])} ({p[top5[0]]:.1%})")
        st.table({
            "class": [class_name(c) for c in top5],
            "probability": [f"{p[c]:.2%}" for c in top5],
        })
        km = keep_masks[:, 0]
        st.pyplot(blackout_montage(img224, km, config.patch_size))
        fig, _ = skips_per_layer_chart(keep_masks)
        st.pyplot(fig)
        strips = layer_strips(img224, km, config.patch_size)
        st.image(strips, caption=[f"Layer {i}" for i in range(len(strips))], width=110)

    tab1, tab2 = st.tabs(["Single image", "Batch"])
    with tab1:
        test_set = load_test_images()
        img224 = None
        up = st.file_uploader("Upload an image", type=["png", "jpg", "jpeg"])
        if up is not None:
            from PIL import Image

            img = Image.open(up).convert("RGB")
            x = pil_preprocess([img], size=config.image_size)
            img224 = np.asarray(img.resize((config.image_size, config.image_size)))
        elif test_set is not None:
            images, labels = test_set
            idx = st.selectbox(
                "…or pick a CIFAR-100 test image",
                range(len(labels)),
                format_func=lambda i: f"#{i} ({class_name(labels[i])})",
            )
            from PIL import Image

            img = Image.fromarray(images[idx])
            x = pil_preprocess([img], size=config.image_size)
            img224 = np.asarray(img.resize((config.image_size, config.image_size)))
        if img224 is not None:
            show_single(img224, x)

    with tab2:
        ups = st.file_uploader(
            "Upload images", type=["png", "jpg", "jpeg"], accept_multiple_files=True
        )
        if ups:
            from PIL import Image

            imgs = [Image.open(u).convert("RGB") for u in ups]
            x = pil_preprocess(imgs, size=config.image_size)
            km, probs = predict(x)  # keep masks [L, B, S]
            preds = probs.argmax(-1)
            st.table({
                "image": [u.name for u in ups],
                "prediction": [class_name(c) for c in preds],
                "confidence": [f"{probs[i, preds[i]]:.1%}" for i in range(len(ups))],
                "mean skip": [f"{100 * (1 - km[:, i, 1:].mean()):.1f}%"
                              for i in range(len(ups))],
            })
            fig, _ = skips_per_layer_chart(km)
            st.pyplot(fig)
            for i, u in enumerate(ups):
                with st.expander(f"{u.name}: per-layer pruning"):
                    img224 = np.asarray(
                        imgs[i].resize((config.image_size, config.image_size))
                    )
                    st.pyplot(blackout_montage(img224, km[:, i], config.patch_size))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
