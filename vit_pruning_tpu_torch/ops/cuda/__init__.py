"""Hand-written CUDA kernels (csrc/) and their wrappers. Building is lazy: see build.py."""
