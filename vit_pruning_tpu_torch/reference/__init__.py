"""Plain float32 references of the models the port serves beside the ViT of
models/vit.py, each in a file of its own that imports nothing of the port's
kernels or models: dinov2 (DINOv2 with registers)."""
