"""ViT image preprocessing constants.

Mirrors vit_pruning_tpu/data/preprocess.py, of which the port keeps only
the normalisation for now: HF `ViTImageProcessor` rescales by 1/255 and
normalises with mean = std = 0.5 per channel. serving.embed_from_u8 and the
fused uint8 patch embedding (ops/cuda/embed.py, kernel B8a) read them. The
resize and the native preprocessing path are still to be ported.
"""

VIT_MEAN = 0.5
VIT_STD = 0.5
