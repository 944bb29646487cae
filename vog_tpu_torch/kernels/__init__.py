"""Hand-written CUDA kernels (sm_90a) with their plain PyTorch versions."""
