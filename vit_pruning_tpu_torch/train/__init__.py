"""Training: predictor and classification losses, freeze policies and their
optimizers, eval metrics, and the phased train / eval harness."""
