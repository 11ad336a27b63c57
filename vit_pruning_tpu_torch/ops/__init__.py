"""Ops: patch embed, attention, masking, structured pruning, kernel dispatch; CUDA kernels in ops/cuda."""
