"""Model code: ViT forward, cls_mlp predictor, progressive top-k forward, weight bridge."""
