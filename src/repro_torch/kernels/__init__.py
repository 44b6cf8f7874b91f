"""Hand-written CUDA kernels of the decision plane and their plain versions."""
